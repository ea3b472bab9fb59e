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
from whisper_tpu_torch.ops.int8_gemm import int8_gemm, int8_gemm_plain
from whisper_tpu_torch.ops.log10_mel import log10_mel, log10_mel_plain
from whisper_tpu_torch.ops.quant import quantize_weight

pytestmark = pytest.mark.cuda

# max |kernel - plain|: fp32 differs by summation order only; bf16 outputs
# may differ by one bf16 ulp (2^-7 at |out| < 2, 2^-8 at |out| < 1)
K1_TOL = {torch.float32: 1e-4, torch.bfloat16: 8e-3}
K2_TOL = {torch.float32: 1e-4, torch.bfloat16: 4e-3}
# K3 with |V| <= 1: fp32 differs by summation order only; bf16 outputs by one
# bf16 rounding of a value below 1 (<= 2^-9), plus the order
K3_TOL = {torch.float32: 1e-5, torch.bfloat16: 4e-3}
# K7: the raw log10 mel, fp32 sums in another order than cuBLAS's; the JAX
# package's own golden tolerance for its fused mel kernel
K7_TOL = 5e-4


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


@pytest.mark.parametrize("M,K,N", [(1500, 1280, 1280), (4500, 1280, 5120), (1500, 5120, 1280),
                                   (3000, 384, 1536), (100, 64, 72), (257, 48, 24), (1, 16, 8)])
def test_int8_gemm_kernel_matches_plain(dev, M, K, N):
    """Exactly equal (int32): turbo's and tiny's widths at ragged M, a K
    that is not a multiple of the 64-byte step, N not a multiple of 128."""
    rng = np.random.default_rng(M + K + N)
    a = torch.from_numpy(rng.integers(-127, 128, (M, K), dtype=np.int8)).to(dev)
    b = torch.from_numpy(rng.integers(-127, 128, (K, N), dtype=np.int8)).to(dev)
    b_k = b.t().contiguous().t()  # the K-major storage the kernel reads
    before = int8_gemm.launches
    got = int8_gemm(a, b_k)
    torch.cuda.synchronize()
    assert int8_gemm.launches == before + 1
    assert got.dtype == torch.int32 and got.shape == (M, N)
    assert torch.equal(got, int8_gemm_plain(a, b))
    extreme = torch.full((M, K), -127, dtype=torch.int8, device=dev)
    assert torch.equal(int8_gemm(extreme, b_k), int8_gemm_plain(extreme, b))
    with pytest.raises(ValueError):  # row-major: the wrapper makes no copy
        int8_gemm(a, b)


def test_linear_a8_on_the_card_through_the_kernel(dev, monkeypatch):
    """The W8A8 linear through K8 equals, bit for bit, the same linear on
    the CPU, and lays the weight out K-major once, in place. The activation
    scale is divided by a tensor: by a Python scalar CUDA multiplies by its
    reciprocal, which this case shows puts scales one ulp off the CPU's."""
    from whisper_tpu_torch.models import model as tm

    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 150, 256)).astype(np.float32))
    w = quantize_weight(torch.from_numpy(rng.standard_normal((256, 384)).astype(np.float32)))
    bias = torch.from_numpy(rng.standard_normal(384).astype(np.float32))
    wd = w.to(dev)
    before = int8_gemm.launches
    got = tm._linear_a8(x.to(dev), wd, bias.to(dev), torch.float32)
    assert int8_gemm.launches == before + 1
    assert wd.k_major() is wd.q and wd.q.t().is_contiguous() and torch.equal(wd.q.cpu(), w.q)
    assert torch.equal(got.cpu(), tm._linear_a8(x, w, bias, torch.float32))
    # batch 1 in the conv stem's transposed layout (a strided view when flattened)
    xt = x[:1].transpose(1, 2).contiguous().transpose(1, 2).to(dev)
    assert torch.equal(tm._linear_a8(xt, wd, None, torch.float32),
                       tm._linear_a8(xt.contiguous(), wd, None, torch.float32))
    monkeypatch.setattr(tm, "int8_gemm", lambda a, b: int8_gemm_plain(a, b))
    assert torch.equal(got, tm._linear_a8(x.to(dev), wd, bias.to(dev), torch.float32))
    amax = torch.clamp(x.abs().amax(dim=-1, keepdim=True), min=1e-8)
    assert not torch.equal((amax.to(dev) / 127.0).cpu(), amax / 127.0)


@pytest.mark.parametrize("n_mels", [80, 128])
@pytest.mark.parametrize("n_frames", [3000, 101])
def test_log10_mel_kernel_matches_plain(dev, n_mels, n_frames):
    """Noise, a tone, a short clip zero-padded and an all-zero row (-10
    everywhere): the raw log10 mel within K7_TOL."""
    rng = np.random.default_rng(n_mels + n_frames)
    L = 160 * n_frames + 400
    t = np.arange(L) / 16000.0
    x = np.stack([rng.standard_normal(L) * 0.1, 0.3 * np.sin(2 * np.pi * 440 * t),
                  np.r_[rng.standard_normal(L // 3) * 0.5, np.zeros(L - L // 3)],
                  np.zeros(L)]).astype(np.float32)
    audio = torch.from_numpy(x).to(dev)
    before = log10_mel.launches
    got = log10_mel(audio, n_mels, 400, 160, n_frames)
    torch.cuda.synchronize()
    assert log10_mel.launches == before + 1
    ref = log10_mel_plain(audio, n_mels, 400, 160, n_frames)
    assert got.shape == ref.shape == (4, n_mels, n_frames)
    assert torch.isfinite(got).all()
    assert float((got - ref).abs().max()) <= K7_TOL
    assert float((got[3] + 10).abs().max()) == 0.0


def test_log_mel_batch_on_the_card_matches_the_cpu(dev):
    from whisper_tpu_torch.ops.mel import log_mel_batch

    rng = np.random.default_rng(9)
    audio = torch.from_numpy((rng.standard_normal((3, 480000)) * 0.1).astype(np.float32))
    audio[1, 16000 * 7:] = 0
    audio[2] = 0
    lengths = torch.tensor([480000, 16000 * 7, 0])
    before = log10_mel.launches
    got = log_mel_batch(audio.to(dev), lengths.to(dev), n_mels=128)
    assert log10_mel.launches == before + 1
    want = log_mel_batch(audio, lengths, n_mels=128)
    assert float((got.cpu() - want).abs().max()) <= K7_TOL / 4  # (x + 4) / 4


def test_new_kernels_refuse_what_they_do_not_take(dev):
    a = torch.zeros((4, 24), dtype=torch.int8, device=dev)  # K % 16 != 0
    with pytest.raises(ValueError):
        int8_gemm(a, torch.zeros((24, 8), dtype=torch.int8, device=dev))
    a = torch.zeros((4, 32), dtype=torch.int8, device=dev)  # N % 8 != 0
    with pytest.raises(ValueError):
        int8_gemm(a, torch.zeros((32, 12), dtype=torch.int8, device=dev))
    with pytest.raises(ValueError):  # int16
        int8_gemm(a.to(torch.int16), torch.zeros((32, 8), dtype=torch.int8, device=dev))
    x = torch.zeros((2, 2000), device=dev)
    with pytest.raises(ValueError):  # another n_fft
        log10_mel(x, 80, 512, 160, 5)
    with pytest.raises(ValueError):  # fp64
        log10_mel(x.double(), 80, 400, 160, 5)
