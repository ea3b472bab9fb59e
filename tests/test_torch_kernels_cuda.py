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
    cross_attention_decode,
    cross_attention_decode_dense,
    cross_attention_decode_dense_plain,
    cross_attention_decode_fd,
    cross_attention_decode_fd_plain,
    cross_attention_decode_plain,
    self_attention_decode,
    self_attention_decode_int8,
    self_attention_decode_int8_plain,
    self_attention_decode_plain,
)
from whisper_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_btd,
    flash_attention_btd_plain,
    flash_attention_btd_sharded,
    flash_attention_plain,
)
from whisper_tpu_torch.ops.int8_gemm import (int8_gemm, int8_gemm_plain, int8_gemm_scaled,
                                             int8_gemm_scaled_plain)
from whisper_tpu_torch.ops.layer_norm_rows import layer_norm_rows, layer_norm_rows_plain
from whisper_tpu_torch.ops.log10_mel import log10_mel, log10_mel_plain
from whisper_tpu_torch.ops.quant import quantize_weight
from whisper_tpu_torch.ops.quantize_rows import quantize_rows, quantize_rows_plain

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
# K7 against the same function in float64: its FFT is float64, so only its
# fp32 power, mel sums and log2 remain (6e-7 measured on turbo noise); an
# fp32 FFT reads 1.4e-4 to 4.2e-4 there, past what this holds
K7_F64_TOL = 1e-5
# K6: K1's kernel on split heads, the same tolerances and reasons
K6_TOL = K1_TOL
# K4: fp32 differs by summation order only (the MXU form rounds nothing in
# fp32); bf16: the query and (MXU form) the weights are rounded on both
# sides, a weight whose rounding falls the other way after another sum
# order moves an output by far less than one bf16 ulp of an output below 2
# (2^-7 = 7.8e-3)
K4_TOL = {torch.float32: 1e-4, torch.bfloat16: 8e-3}
# K5: bf16 operands for every query dtype, so an fp32 output too may move by
# a weight rounded the other way (~w * 2^-8 * |v|, < 1e-3); bf16 outputs by
# one bf16 ulp below 2
K5_TOL = {torch.float32: 1e-3, torch.bfloat16: 8e-3}


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
@pytest.mark.parametrize("B,H,T", [
    (2, 3, 300), (4, 20, 1500), (1, 2, 4),
    # turbo's cross-KV at batch 1, the serving slots and the offline batch
    (1, 20, 1500), (8, 20, 1500), (64, 20, 1500),
    # a tp 2 rank's heads; short T (quarters of one quad, then empty ones)
    (8, 10, 1500), (2, 20, 4), (2, 20, 12), (3, 5, 300),
    # long T: all eight groups in flight, then rings of 3 and 2 stages
    (1, 2, 6400), (1, 2, 12288), (2, 1, 16384)])
def test_cross_attention_decode_fd_kernel_matches_plain(dev, dtype, B, H, T):
    gen = torch.Generator(device=dev).manual_seed(B * T + H)
    ck, cv = (torch.randn((1, B, H, T, 64), generator=gen, device=dev) for _ in range(2))
    k_q, k_s, v_q, v_s = (t[0] for t in quantize_cross_kv((ck, cv)))
    del ck, cv
    q = torch.randn((B, H, 1, 64), generator=gen, device=dev).to(dtype)
    before = cross_attention_decode_fd.launches
    got = cross_attention_decode_fd(q, k_q, k_s, v_q, v_s)
    torch.cuda.synchronize()
    assert cross_attention_decode_fd.launches == before + 1
    ref = cross_attention_decode_fd_plain(q, k_q, k_s, v_q, v_s)
    assert got.dtype == dtype and got.shape == q.shape
    assert float((got.float() - ref.float()).abs().max()) <= K2_TOL[dtype]


def test_cross_attention_decode_fd_refuses_unaligned_and_long_caches(dev):
    """The bulk copies need k_q and v_q 16-byte aligned: a contiguous view
    one byte into its storage is refused, not read from the wrong address;
    so is T past the 16384 whose scores fit in shared memory."""
    q = torch.zeros((1, 2, 1, 64), device=dev)
    s = torch.ones((1, 2, 1, 64), device=dev)
    n = 2 * 64 * 1500
    buf = torch.zeros(n + 1, dtype=torch.int8, device=dev)
    view = buf[1:].view(1, 2, 64, 1500)
    good = torch.zeros((1, 2, 64, 1500), dtype=torch.int8, device=dev)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    for k_q, v_q in ((view, good), (good, view)):
        with pytest.raises(ValueError, match="aligned"):
            cross_attention_decode_fd(q, k_q, s, v_q, s)
    long = torch.zeros((1, 2, 64, 16388), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="16384"):
        cross_attention_decode_fd(q, long, s, long, s)


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


def _check_self(q, kv, kv8, offsets, pads, dtype):
    """Both K3 entry points against their plain versions, one launch each."""
    for fn, plain, cache in ((self_attention_decode, self_attention_decode_plain, kv),
                             (self_attention_decode_int8, self_attention_decode_int8_plain,
                              kv8)):
        before = fn.launches
        got = fn(q, *cache, offsets, pads)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        ref = plain(q, *cache, offsets, pads)
        assert got.dtype == dtype and got.shape == q.shape and torch.isfinite(got).all()
        assert float((got.float() - ref.float()).abs().max()) <= K3_TOL[dtype], fn.__name__


# the decode paths' windows: (batch, cache length, offsets drawn from
# [lo, hi], pads drawn from [0, max_pad]): offline (prompt of 4, 64 new
# tokens), serving (8 slots, 224-token budget), the serving slots' prompted
# rows (initial_prompt contexts up to the cap of 223 tokens: prompts of
# 1 + 223 + 4, a row's pad up to 224), long-form (prompts of up to 226
# tokens, 64 new ones, left-padded by up to 60)
K3_WINDOWS = {"offline": (64, 128, 4, 67, 3), "serving": (8, 256, 4, 227, 3),
              "prompted": (8, 256, 229, 255, 224), "longform": (8, 384, 226, 289, 60)}


@pytest.mark.parametrize("use_pads", [False, True], ids=["nopad", "pad"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("path", list(K3_WINDOWS))
def test_self_attention_decode_at_the_path_windows(dev, path, dtype, use_pads):
    B, T, lo, hi, max_pad = K3_WINDOWS[path]
    rng = np.random.default_rng(T)
    q, kv, kv8 = _self_cache(rng, B, 20, T, dtype, dev)
    offsets = torch.tensor(rng.integers(lo, hi + 1, B), device=dev)
    pads = torch.tensor(rng.integers(0, max_pad + 1, B), device=dev) if use_pads else None
    _check_self(q, kv, kv8, offsets, pads, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("T", [1, 100, 448, 12288])
def test_self_attention_decode_edge_windows(dev, dtype, T):
    """Per row: an empty window (pads past the offset), one key at 0, one key
    at the end, the full cache, and a window inside it; then a scalar offset
    of 0 (one key) and of T - 1 (all), without pads."""
    B = 5
    rng = np.random.default_rng(T + 1)
    q, kv, kv8 = _self_cache(rng, B, 3, T, dtype, dev)
    offsets = torch.tensor([0, 0, T - 1, T - 1, (3 * T) // 4], device=dev)
    pads = torch.tensor([1, 0, T - 1, 0, T // 4], device=dev)
    if T == 1:  # the empty row's pad 1 lies past the cache
        assert int(pads[0]) > int(offsets[0])
    _check_self(q, kv, kv8, offsets, pads, dtype)
    for off in (0, T - 1):
        _check_self(q, kv, kv8, off, None, dtype)


@pytest.mark.parametrize("B,H", [(3, 2), (28, 20)], ids=["few_rows", "many_rows"])
@pytest.mark.parametrize("T", [128, 100, 1])
def test_self_attention_decode_reads_unaligned_views(dev, T, B, H):
    """Cache views that start one element (and, for int8, one byte) into
    their storage: the kernel falls back to narrower copies in the same
    launch, and still matches the plain version; with few (batch, head)
    rows (64-byte chunks) and with many (128-byte chunks)."""
    rng = np.random.default_rng(7)
    for dtype in (torch.float32, torch.bfloat16):
        q, (k, v), (kv_q, kv_s) = _self_cache(rng, B, H, T, dtype, dev)

        def shift(t):
            buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
            view = buf[1:].view(t.shape)
            view.copy_(t)
            assert view.is_contiguous() and view.data_ptr() % 16 != 0
            return view

        offsets = torch.tensor(([T - 1, T // 2, 0] * B)[:B], device=dev)
        pads = torch.tensor(([0, T // 4, 0] * B)[:B], device=dev)
        _check_self(q, (shift(k), shift(v)), (shift(kv_q), shift(kv_s)), offsets, pads, dtype)


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
                                   (3000, 384, 1536), (100, 64, 72), (257, 48, 24), (1, 16, 8),
                                   # turbo's encoder at tp 2, per rank: q/k/v, o, mlp w1, w2
                                   (1500, 1280, 640), (1500, 640, 1280), (4500, 1280, 2560),
                                   (1500, 2560, 1280)])
def test_int8_gemm_kernel_matches_plain(dev, M, K, N):
    """Exactly equal (int32), and bit-equal in the scaled epilogue (bf16 and
    fp32 out, with and without a bias): turbo's and tiny's widths at ragged
    M, K below and not a multiple of the 128-byte stage, N not a multiple
    of the 256-column tile."""
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
    sx = torch.from_numpy(rng.uniform(1e-3, 5e-2, (M, 1)).astype(np.float32)).to(dev)
    ws = torch.from_numpy(rng.uniform(1e-4, 1e-2, (1, N)).astype(np.float32)).to(dev)
    bias = torch.from_numpy(rng.standard_normal(N).astype(np.float32) * 4).to(dev)
    for dtype in (torch.bfloat16, torch.float32):
        for bb in (bias.to(dtype), None):
            before = int8_gemm.launches
            out = int8_gemm_scaled(a, b_k, sx, ws, bb, dtype)
            torch.cuda.synchronize()
            assert int8_gemm.launches == before + 1
            assert out.dtype == dtype and out.shape == (M, N)
            assert torch.equal(out, int8_gemm_scaled_plain(a, b, sx, ws, bb, dtype)), (dtype, bb)


def _rows_with_ties(rng, M, K):
    """M seeded rows of width K: noise, every fifth row all zero, and rows
    whose x / sx lands exactly on .5 (amax 127: sx = 1; amax 254: sx = 2)."""
    x = rng.standard_normal((M, K)).astype(np.float32) * 3
    x[::5] = 0.0
    ties = np.resize(np.float32([0.5, -1.5, 2.5, -3.5, 40.5, 0.0]), K)
    x[1::7] = ties
    x[1::7, 0] = 127.0
    x[2::7] = ties * 2
    x[2::7, 0] = 254.0
    return x


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("M,K", [(1500, 1280), (4500, 5120), (3000, 640), (1500, 2560),
                                 (257, 48), (1, 16), (33, 8192), (100, 64)])
def test_quantize_rows_kernel_matches_plain(dev, dtype, M, K):
    """K8q bit-equal to its plain version: turbo's widths and their tp 2
    halves at ragged M, the narrowest and widest K it takes, .5 ties
    (rounded to even) and zero rows; and at a given scale."""
    rng = np.random.default_rng(M * 3 + K)
    x = torch.from_numpy(_rows_with_ties(rng, M, K)).to(dev, dtype)
    before = quantize_rows.launches
    q, sx = quantize_rows(x)
    torch.cuda.synchronize()
    assert quantize_rows.launches == before + 1
    want_q, want_sx = quantize_rows_plain(x)
    assert q.dtype == torch.int8 and q.shape == (M, K) and sx.shape == (M, 1)
    assert torch.equal(sx, want_sx)
    assert torch.equal(q, want_q)
    assert torch.equal(q.cpu(), quantize_rows_plain(x.cpu())[0])  # card == CPU
    given = torch.from_numpy(rng.uniform(0.01, 0.1, (M, 1)).astype(np.float32)).to(dev)
    q2, s2 = quantize_rows(x, given)
    assert s2 is given and torch.equal(q2, quantize_rows_plain(x, given)[0])


def test_quantize_rows_refuses_what_it_does_not_take(dev):
    x = torch.zeros((4, 64), device=dev)
    for bad in (torch.zeros((4, 24), device=dev),        # K % 16 != 0
                torch.zeros((4, 8208), device=dev),      # K > 8192
                x.half(),                                # fp16
                torch.zeros((4, 128), device=dev)[:, :64],  # not contiguous
                torch.zeros((2, 4, 64), device=dev)):    # not 2-D
        with pytest.raises(ValueError):
            quantize_rows(bad)
    for sx in (torch.ones((4,), device=dev), torch.ones((4, 1), device=dev).double(),
               torch.ones((3, 1), device=dev)):
        with pytest.raises(ValueError):
            quantize_rows(x, sx)
    a8, w8 = torch.zeros((4, 64), dtype=torch.int8, device=dev), torch.zeros(
        (8, 64), dtype=torch.int8, device=dev).t()
    s4, s8 = torch.ones((4, 1), device=dev), torch.ones((1, 8), device=dev)
    with pytest.raises(ValueError):  # fp16 out
        int8_gemm_scaled(a8, w8, s4, s8, None, torch.half)
    with pytest.raises(ValueError):  # the channel scales of another width
        int8_gemm_scaled(a8, w8, s4, torch.ones((1, 16), device=dev), None, torch.float32)
    with pytest.raises(ValueError):  # bf16 row scales
        int8_gemm_scaled(a8, w8, s4.bfloat16(), s8, None, torch.float32)


def _assert_near_rows(q, sx, want_q, want_sx, dtype=torch.bfloat16):
    """K8n against its plain version: its LayerNorm sums rows in another
    order. A bf16 output can then round to the neighbouring bf16 value,
    which flips an int8 entry by one or, at a row's maximum, moves the row's
    scale by one bf16 ulp of that maximum over 127 (scales equal on 99% of
    rows); an fp32 output (not rounded) moves by a few fp32 ulps, and its
    scale with it (8 ulps)."""
    diff = (q.int() - want_q.int()).abs()
    assert int(diff.max()) <= 1 and float((diff == 0).float().mean()) >= 0.999
    if dtype == torch.bfloat16:
        amax = want_sx * 127.0
        ulp = torch.exp2(torch.floor(torch.log2(amax)) - 7)  # bf16: 8 significant bits
        assert bool(((sx - want_sx).abs() * 127.0 <= ulp * 1.001).all())
        assert float((sx == want_sx).float().mean()) >= 0.99
    else:
        assert float(((sx - want_sx).abs() / want_sx).max()) <= 2.0 ** -20


@pytest.mark.parametrize("M,D", [(1, 384), (7, 384), (4500, 384), (1, 1280), (7, 1280),
                                 (4500, 1280), (96000, 1280)])
def test_layer_norm_rows_kernel_matches_plain(dev, M, D):
    """K8n against ``layer_norm`` then ``quantize_rows_plain`` on bf16 rows
    (with offsets and spreads that differ by row) and random bf16 gains and
    bias, at tiny's and turbo's widths, the encoder's own M = 96,000
    included: int8 entries one apart at most and equal on 99.9%, scales
    within a bf16 ulp of the row maximum and equal on 99% of rows; one
    launch a call, and a second launch gives the same bits."""
    rng = np.random.default_rng(M + D)
    x = (rng.standard_normal((M, D)) * rng.uniform(0.1, 8, (M, 1))
         + rng.uniform(-2, 2, (M, 1)))
    x = torch.from_numpy(x.astype(np.float32)).to(dev, torch.bfloat16)
    g = torch.from_numpy(1 + 0.3 * rng.standard_normal(D).astype(np.float32)).to(dev,
                                                                                torch.bfloat16)
    b = torch.from_numpy(0.2 * rng.standard_normal(D).astype(np.float32)).to(dev, torch.bfloat16)
    before = layer_norm_rows.launches
    q, sx = layer_norm_rows(x, g, b)
    torch.cuda.synchronize()
    assert layer_norm_rows.launches == before + 1
    assert q.dtype == torch.int8 and q.shape == (M, D) and sx.shape == (M, 1)
    _assert_near_rows(q, sx, *layer_norm_rows_plain(x, g, b))
    q2, sx2 = layer_norm_rows(x, g, b)
    assert layer_norm_rows.launches == before + 2
    assert torch.equal(q2, q) and torch.equal(sx2, sx)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("M,D", [(257, 16), (300, 2560), (64, 5120), (33, 8192)])
def test_layer_norm_rows_kernel_other_widths(dev, dtype, M, D):
    """bf16 rows, and fp32 rows (whose LayerNorm output is not rounded),
    with gains and bias of their dtype, at a width below one warp's and at
    the widest of two, four and eight warps a row."""
    rng = np.random.default_rng(D)
    x = torch.from_numpy(rng.standard_normal((M, D)).astype(np.float32) * 3).to(dev, dtype)
    g = torch.from_numpy(rng.standard_normal(D).astype(np.float32)).to(dev, dtype)
    b = torch.from_numpy(rng.standard_normal(D).astype(np.float32)).to(dev, dtype)
    q, sx = layer_norm_rows(x, g, b)
    _assert_near_rows(q, sx, *layer_norm_rows_plain(x, g, b), dtype=dtype)


def test_layer_norm_rows_refuses_what_it_does_not_take(dev):
    g = torch.ones(64, device=dev)
    for bad in (torch.zeros((4, 24), device=dev),          # D % 16 != 0
                torch.zeros((4, 8208), device=dev),        # D > 8192
                torch.zeros((4, 128), device=dev)[:, :64],  # not contiguous
                torch.zeros((4, 64), device=dev).half(),    # fp16
                torch.zeros((2, 4, 64), device=dev)):      # not 2-D
        with pytest.raises(ValueError):
            layer_norm_rows(bad, torch.ones(bad.shape[-1], device=dev),
                            torch.zeros(bad.shape[-1], device=dev))
    x = torch.zeros((4, 64), device=dev)
    for gb in ((g[:32], g[:32]), (g.half(), g.half()), (g, g.bfloat16()),
               (g.bfloat16(), g.bfloat16()), (torch.ones(128, device=dev)[::2], g)):
        with pytest.raises(ValueError):
            layer_norm_rows(x, *gb)


def _card_kernels(fn) -> list:
    """Names of the kernels ``fn`` launches on the card (torch.profiler; the
    first window of a process can miss the card's activity)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
        if names:
            return names
    raise AssertionError("torch.profiler recorded nothing on the card")


def test_linear_a8_on_the_card_through_the_kernel(dev, monkeypatch):
    """The W8A8 linear is one K8q and one K8 launch and no other kernel; it
    equals, bit for bit, the same linear on the CPU, and lays the weight out
    K-major once, in place. The activation scale is divided by a tensor: by
    a Python scalar CUDA multiplies by its reciprocal, which this case shows
    puts scales one ulp off the CPU's."""
    from whisper_tpu_torch.models import model as tm

    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 150, 256)).astype(np.float32))
    w = quantize_weight(torch.from_numpy(rng.standard_normal((256, 384)).astype(np.float32)))
    bias = torch.from_numpy(rng.standard_normal(384).astype(np.float32))
    wd = w.to(dev)
    before = (quantize_rows.launches, int8_gemm.launches)
    got = tm._linear_a8(x.to(dev), wd, bias.to(dev), torch.float32)
    assert (quantize_rows.launches, int8_gemm.launches) == (before[0] + 1, before[1] + 1)
    assert wd.k_major() is wd.q and wd.q.t().is_contiguous() and torch.equal(wd.q.cpu(), w.q)
    assert torch.equal(got.cpu(), tm._linear_a8(x, w, bias, torch.float32))
    xb, bb = x.to(dev, torch.bfloat16), bias.to(dev, torch.bfloat16)
    names = _card_kernels(lambda: tm._linear_a8(xb, wd, bb, torch.bfloat16))
    kinds = sorted(next((k for k in ("int8_gemm_sm90", "quantize_rows_kernel") if k in n), n)
                   for n in names)
    assert kinds == ["int8_gemm_sm90", "quantize_rows_kernel"], names
    assert torch.equal(tm._linear_a8(xb, wd, bb, torch.bfloat16).cpu(),
                       tm._linear_a8(xb.cpu(), w, bb.cpu(), torch.bfloat16))
    # batch 1 in the conv stem's old transposed layout (a strided view when flattened)
    xt = x[:1].transpose(1, 2).contiguous().transpose(1, 2).to(dev)
    assert torch.equal(tm._linear_a8(xt, wd, None, torch.float32),
                       tm._linear_a8(xt.contiguous(), wd, None, torch.float32))
    monkeypatch.setattr(tm, "int8_gemm_scaled", int8_gemm_scaled_plain)
    monkeypatch.setattr(tm, "quantize_rows", quantize_rows_plain)
    assert torch.equal(got, tm._linear_a8(x.to(dev), wd, bias.to(dev), torch.float32))
    amax = torch.clamp(x.abs().amax(dim=-1, keepdim=True), min=1e-8)
    assert not torch.equal((amax.to(dev) / 127.0).cpu(), amax / 127.0)


def _mel_rows(n_frames: int, seed: int) -> np.ndarray:
    """Noise, a 440 Hz tone, a short clip zero-padded, an all-zero row and
    an impulse train, as reflect-padded audio of n_frames frames."""
    rng = np.random.default_rng(seed)
    L = 160 * n_frames + 400
    t = np.arange(L) / 16000.0
    return np.stack([rng.standard_normal(L) * 0.1, 0.3 * np.sin(2 * np.pi * 440 * t),
                     np.r_[rng.standard_normal(L // 3) * 0.5, np.zeros(L - L // 3)],
                     np.zeros(L), (np.arange(L) % 397 == 0) * 0.8]).astype(np.float32)


def _log10_mel_f64(audio: torch.Tensor, n_mels: int, n_frames: int) -> torch.Tensor:
    """The raw log10 mel of reflect-padded audio, in float64 throughout."""
    from whisper_tpu_torch.ops.mel import _frame, mel_filterbank

    hann = torch.hann_window(400, periodic=True, dtype=torch.float64, device=audio.device)
    spec = torch.fft.rfft(_frame(audio.double(), n_frames, 400, 160) * hann, dim=-1)
    fb = torch.from_numpy(mel_filterbank(n_mels, 400)).to(audio.device, torch.float64)
    return torch.log10(torch.clamp(fb @ (spec.abs() ** 2).transpose(1, 2), min=1e-10))


@pytest.mark.parametrize("n_mels", [80, 128])
@pytest.mark.parametrize("n_frames", [3000, 101, 1])
def test_log10_mel_kernel_matches_plain(dev, n_mels, n_frames):
    """Noise, a tone, a short clip zero-padded, an all-zero row (-10
    everywhere) and an impulse train: the raw log10 mel within K7_TOL of
    the plain version and within K7_F64_TOL of the float64 function."""
    audio = torch.from_numpy(_mel_rows(n_frames, n_mels + n_frames)).to(dev)
    before = log10_mel.launches
    got = log10_mel(audio, n_mels, 400, 160, n_frames)
    torch.cuda.synchronize()
    assert log10_mel.launches == before + 1
    ref = log10_mel_plain(audio, n_mels, 400, 160, n_frames)
    assert got.shape == ref.shape == (5, n_mels, n_frames)
    assert torch.isfinite(got).all()
    assert float((got - ref).abs().max()) <= K7_TOL
    exact = _log10_mel_f64(audio, n_mels, n_frames)
    assert float((got.double() - exact).abs().max()) <= K7_F64_TOL
    assert float((got[3] + 10).abs().max()) == 0.0


@pytest.mark.parametrize("n_mels", [80, 128])
@pytest.mark.parametrize("B", [1, 8])
def test_log10_mel_kernel_batches(dev, B, n_mels):
    """One row and the serving admission batch of eight 30 s rows (the five
    kinds of row, then noise at other levels), within K7_TOL of the plain
    version and K7_F64_TOL of the float64 function."""
    rows = _mel_rows(3000, B)
    scales = np.array([0.01, 1.0, 3.0], np.float32)[:, None]
    rows = np.concatenate([rows, rows[:1] * scales * 10])[:B]
    audio = torch.from_numpy(np.ascontiguousarray(rows)).to(dev)
    got = log10_mel(audio, n_mels, 400, 160, 3000)
    ref = log10_mel_plain(audio, n_mels, 400, 160, 3000)
    assert got.shape == ref.shape == (B, n_mels, 3000)
    assert float((got - ref).abs().max()) <= K7_TOL
    exact = _log10_mel_f64(audio, n_mels, 3000)
    assert float((got.double() - exact).abs().max()) <= K7_F64_TOL


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,H,Tq,Tk", [(2, 4, 150, 150), (1, 20, 1500, 1500), (2, 3, 37, 261),
                                       (1, 2, 100, 64), (3, 1, 1, 1)])
def test_flash_attention_kernel_matches_plain(dev, dtype, B, H, Tq, Tk):
    """K6 at a ragged T, turbo's one-row shape, Tq < Tk, Tq > Tk and one key."""
    rng = np.random.default_rng(Tq * 7 + Tk)
    q = torch.from_numpy(rng.standard_normal((B, H, Tq, 64)).astype(np.float32)).to(dev, dtype)
    k, v = (torch.from_numpy(rng.standard_normal((B, H, Tk, 64)).astype(np.float32))
            .to(dev, dtype) for _ in range(2))
    before = flash_attention.launches
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref = flash_attention_plain(q, k, v)
    assert got.dtype == dtype and got.shape == q.shape
    assert float((got.float() - ref.float()).abs().max()) <= K6_TOL[dtype]


def _int8_cross(rng, B, H, T, dtype, dev):
    ck, cv = (torch.from_numpy(rng.standard_normal((1, B, H, T, 64)).astype(np.float32)).to(dev)
              for _ in range(2))
    k_q, k_s, v_q, v_s = (t[0] for t in quantize_cross_kv((ck, cv)))
    q = torch.from_numpy(rng.standard_normal((B, H, 1, 64)).astype(np.float32)).to(dev, dtype)
    return q, k_q, k_s, v_q, v_s


@pytest.mark.parametrize("use_vpu", [False, True], ids=["mxu", "vpu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,H,T", [(2, 3, 300), (4, 20, 1500), (1, 2, 4)])
def test_cross_attention_decode_kernel_matches_plain(dev, dtype, use_vpu, B, H, T):
    args = _int8_cross(np.random.default_rng(T + 1), B, H, T, dtype, dev)
    before = cross_attention_decode.launches
    got = cross_attention_decode(*args, use_vpu=use_vpu)
    torch.cuda.synchronize()
    assert cross_attention_decode.launches == before + 1
    ref = cross_attention_decode_plain(*args, use_vpu=use_vpu)
    assert got.dtype == dtype and got.shape == args[0].shape
    assert float((got.float() - ref.float()).abs().max()) <= K4_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,H,T", [(2, 3, 300), (4, 20, 1500), (2, 6, 1500), (1, 32, 1500),
                                   (1, 1, 4)])
def test_cross_attention_decode_dense_kernel_matches_plain(dev, dtype, B, H, T):
    """K5 at turbo's and tiny's heads, the most heads it takes (two m-tiles,
    four n-tiles), a ragged T tile and one head of four positions."""
    args = _int8_cross(np.random.default_rng(T + 2), B, H, T, dtype, dev)
    before = cross_attention_decode_dense.launches
    got = cross_attention_decode_dense(*args)
    torch.cuda.synchronize()
    assert cross_attention_decode_dense.launches == before + 1
    ref = cross_attention_decode_dense_plain(*args)
    assert got.dtype == dtype and got.shape == args[0].shape
    assert float((got.float() - ref.float()).abs().max()) <= K5_TOL[dtype]


def _int8_cross_card(seed, B, H, T, dtype, dev):
    """_int8_cross drawn on the card (the larger shapes would take long in
    numpy)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    ck, cv = (torch.randn((1, B, H, T, 64), generator=gen, device=dev) for _ in range(2))
    k_q, k_s, v_q, v_s = (t[0] for t in quantize_cross_kv((ck, cv)))
    del ck, cv
    q = torch.randn((B, H, 1, 64), generator=gen, device=dev).to(dtype)
    return q, k_q, k_s, v_q, v_s


def _dense_check(args, dtype):
    before = cross_attention_decode_dense.launches
    got = cross_attention_decode_dense(*args)
    torch.cuda.synchronize()
    assert cross_attention_decode_dense.launches == before + 1
    ref = cross_attention_decode_dense_plain(*args)
    assert got.dtype == dtype and got.shape == args[0].shape
    assert torch.isfinite(got.float()).all()
    assert float((got.float() - ref.float()).abs().max()) <= K5_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,H,T", [(b, h, 1500) for b in (1, 8, 64) for h in (1, 6, 20, 32)]
                         + [(b, h, t) for b, h in ((1, 1), (8, 20), (64, 20), (1, 32))
                            for t in (4, 300)]
                         + [(1, 1, 12288), (8, 20, 12288), (1, 32, 12288)])
def test_cross_attention_decode_dense_shapes(dev, dtype, B, H, T):
    """K5 over the batches of the paths (1, 8, 64), tiny's to the most heads
    (1, 6, 20, 32), and T from one char4 (4) past a slice's ragged edge
    (300) to turbo's 1500 and the wrapper's cap (12288)."""
    _dense_check(_int8_cross_card(B * 1000 + H * 10 + T, B, H, T, dtype, dev), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,T", [(1, 1500), (8, 1500), (2, 12288)])
def test_cross_attention_decode_dense_peaked_and_flat(dev, dtype, B, T):
    """One dominant position per head (its score ~32 above the rest: weights
    of ~1e-14 elsewhere, the global max in one slice of the cluster) and a
    flat softmax (q = 0: every weight bf16(1 / T))."""
    H = 20
    gen = torch.Generator(device=dev).manual_seed(T + B)
    ck = torch.randn((1, B, H, T, 64), generator=gen, device=dev) * 0.05
    cv = torch.randn((1, B, H, T, 64), generator=gen, device=dev) * 0.2  # |out| < 2
    peak = torch.randint(0, T, (B, H), generator=gen, device=dev)
    ck[0].scatter_(2, peak[:, :, None, None].expand(B, H, 1, 64),
                   torch.ones((B, H, 1, 64), device=dev))
    k_q, k_s, v_q, v_s = (t[0] for t in quantize_cross_kv((ck, cv)))
    q = torch.full((B, H, 1, 64), 4.0, device=dev).to(dtype)
    _dense_check((q, k_q, k_s, v_q, v_s), dtype)
    got = cross_attention_decode_dense(q, k_q, k_s, v_q, v_s).float()
    at_peak = torch.gather(v_q.float(), 3, peak[:, :, None, None].expand(B, H, 64, 1))
    want = at_peak.transpose(-1, -2) * v_s  # the weight at the peak rounds to 1
    assert float((got - want).abs().max()) <= K5_TOL[dtype]
    _dense_check((torch.zeros_like(q), k_q, k_s, v_q, v_s), dtype)


def test_cross_attention_decode_dense_refuses_long_and_unaligned(dev):
    q = torch.zeros((1, 2, 1, 64), device=dev)
    s = torch.ones((1, 2, 1, 64), device=dev)
    kq = torch.zeros((1, 2, 64, 12292), dtype=torch.int8, device=dev)  # above the cap
    with pytest.raises(ValueError):
        cross_attention_decode_dense(q, kq, s, kq, s)
    n = 2 * 64 * 1500
    buf = torch.zeros(n + 16, dtype=torch.int8, device=dev)
    view = buf[4:4 + n].view(1, 2, 64, 1500)  # contiguous, 4 bytes past 16-byte alignment
    ok = buf[:n].view(1, 2, 64, 1500)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    before = cross_attention_decode_dense.launches
    for k, v in ((view, ok), (ok, view)):
        with pytest.raises(ValueError):
            cross_attention_decode_dense(q, k, s, v, s)
    assert cross_attention_decode_dense.launches == before


def test_variant_kernels_refuse_what_they_do_not_take(dev):
    q = torch.zeros((1, 2, 8, 64), device=dev)
    with pytest.raises(ValueError):  # fp16
        flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError):  # head dim 32
        flash_attention(q[..., :32].contiguous(), q[..., :32].contiguous(),
                        q[..., :32].contiguous())
    with pytest.raises(ValueError):  # not contiguous
        flash_attention(q.transpose(1, 2), q.transpose(1, 2), q.transpose(1, 2))
    with pytest.raises(ValueError):  # k and v differ
        flash_attention(q, q, q[:, :, :4].contiguous())
    q1 = torch.zeros((1, 2, 1, 64), device=dev)
    s = torch.ones((1, 2, 1, 64), device=dev)
    for fn in (cross_attention_decode, cross_attention_decode_dense):
        kq = torch.zeros((1, 2, 64, 6), dtype=torch.int8, device=dev)  # T % 4 != 0
        with pytest.raises(ValueError):
            fn(q1, kq, s, kq, s)
    kq = torch.zeros((1, 2, 64, 12800), dtype=torch.int8, device=dev)  # scores over 48 KB
    with pytest.raises(ValueError):
        cross_attention_decode(q1, kq, s, kq, s)
    q33, s33 = torch.zeros((1, 33, 1, 64), device=dev), torch.ones((1, 33, 1, 64), device=dev)
    kq = torch.zeros((1, 33, 64, 8), dtype=torch.int8, device=dev)  # 33 heads
    with pytest.raises(ValueError):
        cross_attention_decode_dense(q33, kq, s33, kq, s33)


# --- the TMA + wgmma kernel of K1 and K6 (csrc/flash_attention_sm90.cuh):
# blocks of 192 query rows (three warpgroups of 64), K/V tiles of 128 keys


def _bf16(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))


@pytest.mark.parametrize("T", [1, 63, 64, 92, 128, 129, 191, 192, 193, 1500])
def test_flash_attention_btd_ragged_tiles(dev, T):
    """Ragged q tiles (192 rows) and k tiles (128 keys): rows past T are
    zero-filled by the TMA, keys past T masked, rows past T never written."""
    rng = np.random.default_rng(T + 11)
    q, k, v = (_bf16(rng, 2, T, 128).to(dev, torch.bfloat16) for _ in range(3))
    got = flash_attention_btd(q, k, v, 2)
    torch.cuda.synchronize()
    ref = flash_attention_btd_plain(q, k, v, 2)
    assert torch.isfinite(got.float()).all()
    assert float((got.float() - ref.float()).abs().max()) <= K1_TOL[torch.bfloat16]


@pytest.mark.parametrize("B", [1, 3, 8])
def test_flash_attention_btd_admission_batches(dev, B):
    """The serving path's ragged admission sizes at turbo's width."""
    rng = np.random.default_rng(B)
    q, k, v = (_bf16(rng, B, 1500, 1280).to(dev, torch.bfloat16) for _ in range(3))
    got = flash_attention_btd(q, k, v, 20)
    torch.cuda.synchronize()
    ref = flash_attention_btd_plain(q, k, v, 20)
    assert float((got.float() - ref.float()).abs().max()) <= K1_TOL[torch.bfloat16]


@pytest.mark.parametrize("Tq,Tk", [(300, 1500), (1500, 448), (1, 1500), (1500, 1), (193, 129)])
def test_flash_attention_tq_not_tk(dev, Tq, Tk):
    """K6 with separate tensor maps for Q/O (Tq rows) and K/V (Tk rows)."""
    rng = np.random.default_rng(Tq * 3 + Tk)
    q = _bf16(rng, 2, 3, Tq, 64).to(dev, torch.bfloat16)
    k, v = (_bf16(rng, 2, 3, Tk, 64).to(dev, torch.bfloat16) for _ in range(2))
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    ref = flash_attention_plain(q, k, v)
    assert float((got.float() - ref.float()).abs().max()) <= K6_TOL[torch.bfloat16]


@pytest.mark.parametrize("T", [150, 1500])
def test_no_bleed_across_batch_rows(dev, T):
    """Row b's last, ragged tile must not see row b+1's keys (a 2-D map over
    (B*T, D) would read them): with row b+1's K and V made large, row b's
    output equals row b computed alone, bit for bit; K6 likewise across
    heads."""
    rng = np.random.default_rng(T)
    q, k, v = (_bf16(rng, 3, T, 128) for _ in range(3))
    k[1:] *= 50.0
    v[1:] += 1000.0
    q, k, v = (t.to(dev, torch.bfloat16) for t in (q, k, v))
    whole = flash_attention_btd(q, k, v, 2)
    alone = flash_attention_btd(q[:1].contiguous(), k[:1].contiguous(), v[:1].contiguous(), 2)
    torch.cuda.synchronize()
    assert torch.equal(whole[:1], alone)
    assert float(alone.float().abs().max()) < 10.0
    qh, kh, vh = (t.reshape(3, T, 2, 64).transpose(1, 2).contiguous() for t in (q, k, v))
    whole = flash_attention(qh, kh, vh)
    alone = flash_attention(qh[:1].contiguous(), kh[:1].contiguous(), vh[:1].contiguous())
    torch.cuda.synchronize()
    assert torch.equal(whole[:1], alone)


def test_flash_attention_refuses_unaligned_views(dev):
    """TMA needs 16-byte aligned tensors: a contiguous view that starts one
    element into its storage is refused, not read from the wrong address."""
    for shape, fn in (((1, 64, 128), lambda t: flash_attention_btd(t, t, t, 2)),
                      ((1, 2, 64, 64), lambda t: flash_attention(t, t, t))):
        n = int(np.prod(shape))
        buf = torch.zeros(n + 1, dtype=torch.bfloat16, device=dev)
        view = buf[1:].view(shape)
        assert view.is_contiguous() and view.data_ptr() % 16 != 0
        with pytest.raises(ValueError):
            fn(view)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_flash_attention_btd_sharded_matches_full_k1(dev, dtype, tp):
    """The sharded entry on a (1, tp) mesh of one card (turbo's 20 heads of
    64, so 10 or 5 local heads) against the full kernel: attention is per
    head, so every local launch computes the full launch's columns; and
    against the plain version within K1's tolerance. One K1 launch per
    rank, each counted as a sharded launch too."""
    from whisper_tpu_torch.parallel.sharding import make_mesh

    rng = np.random.default_rng(tp)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 300, 1280)).astype(np.float32))
               .to(dev, dtype) for _ in range(3))
    before = (flash_attention_btd.launches, flash_attention_btd_sharded.launches)
    got = flash_attention_btd_sharded(q, k, v, 20, make_mesh(1, tp, devices=[dev] * tp))
    torch.cuda.synchronize()
    assert (flash_attention_btd.launches, flash_attention_btd_sharded.launches) == (
        before[0] + tp, before[1] + tp)
    full = flash_attention_btd(q, k, v, 20)
    assert float((got.float() - full.float()).abs().max()) <= K1_TOL[dtype]
    ref = flash_attention_btd_plain(q, k, v, 20)
    assert float((got.float() - ref.float()).abs().max()) <= K1_TOL[dtype]


def test_launches_on_other_cards_leave_the_current_device(dev):
    """A tensor-parallel forward launches on several cards from one thread:
    every kernel, launched on the last card while the first is current,
    leaves the first current (events and ``synchronize()`` without a device
    read it); the sharded entry over distinct cards equals the full K1 on
    the first."""
    from whisper_tpu_torch.parallel.sharding import make_mesh

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more CUDA cards")
    first, last = torch.device("cuda", 0), torch.device("cuda", n - 1)
    torch.cuda.set_device(first)
    rng = np.random.default_rng(7)

    def rand(*shape, device=last, dtype=torch.bfloat16):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device, dtype)

    q, k, v = (rand(2, 150, 640) for _ in range(3))
    kq, ks, vq, vs = (t[0] for t in quantize_cross_kv((rand(1, 2, 10, 160, 64),
                                                      rand(1, 2, 10, 160, 64))))
    qd = rand(2, 10, 1, 64)
    cache = tuple(t.contiguous() for t in quantize_kv_heads(rand(2, 10, 32, 64),
                                                            rand(2, 10, 32, 64)))
    offsets = torch.full((2,), 5, dtype=torch.int64, device=last)
    a8 = torch.from_numpy(rng.integers(-127, 128, (64, 128), dtype=np.int8)).to(last)
    w8 = torch.from_numpy(rng.integers(-127, 128, (128, 64), dtype=np.int8)).to(last)
    launches = [lambda: flash_attention_btd(q, k, v, 10),
                lambda: flash_attention(*(t.reshape(2, 150, 10, 64).transpose(1, 2).contiguous()
                                          for t in (q, k, v))),
                lambda: cross_attention_decode_fd(qd, kq, ks, vq, vs),
                lambda: cross_attention_decode(qd, kq, ks, vq, vs),
                lambda: cross_attention_decode_dense(qd, kq, ks, vq, vs),
                lambda: self_attention_decode_int8(qd, *cache, offsets, None),
                lambda: int8_gemm(a8, w8.t().contiguous().t()),
                lambda: int8_gemm_scaled(a8, w8.t().contiguous().t(),
                                         torch.ones((64, 1), device=last),
                                         torch.ones((1, 64), device=last), None, torch.bfloat16),
                lambda: quantize_rows(rand(64, 128)),
                lambda: layer_norm_rows(rand(64, 128), rand(128), rand(128)),
                lambda: log10_mel(rand(2, 160 * 101 + 400, dtype=torch.float32), 80, 400, 160,
                                  101)]
    for fn in launches:
        fn()
        assert torch.cuda.current_device() == 0
    torch.cuda.synchronize(last)
    qf, kf, vf = (rand(2, 150, 1280) for _ in range(3))
    got = flash_attention_btd_sharded(qf, kf, vf, 20, make_mesh(1, 2, devices=[last, first]))
    assert got.device == last and torch.cuda.current_device() == 0
    want = flash_attention_btd(qf.to(first), kf.to(first), vf.to(first), 20)
    assert torch.equal(got.to(first), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,H", [(1, 20), (8, 20), (64, 20), (4, 6)])
def test_self_attention_decode_at_the_detection_step(dev, dtype, B, H):
    """The float K3 where language detection runs it: one ``[sot]`` at
    offset 0 in a cache of 128 positions (only key 0 visible), batches 1 to
    64, turbo's 20 heads and tiny's 6."""
    rng = np.random.default_rng(B * H)
    q, (k, v), _ = _self_cache(rng, B, H, 128, dtype, dev)
    before = self_attention_decode.launches
    got = self_attention_decode(q, k, v, 0)
    torch.cuda.synchronize()
    assert self_attention_decode.launches == before + 1
    ref = self_attention_decode_plain(q, k, v, 0)
    assert got.dtype == dtype and got.shape == q.shape
    assert float((got.float() - ref.float()).abs().max()) <= K3_TOL[dtype]
    # one visible key: the output is its value row
    want = v[:, :, :, 0].float()[:, :, None, :]
    assert float((got.float() - want).abs().max()) <= K3_TOL[dtype]


def test_engine_language_column_write_keeps_explicit_rows(dev):
    """One admission batch of auto and explicit rows on the card (tiny,
    fp32, int8 cross- and self-KV): the detected language tokens land in the
    auto rows' prompts only; the explicit rows keep their own and decode
    the texts they decode in a batch without auto rows."""
    from whisper_tpu_torch.config import LANGUAGES, get_config
    from whisper_tpu_torch.params import init_params
    from whisper_tpu_torch.serving.engine import ContinuousBatchingEngine, Request
    from whisper_tpu_torch.tokenizer import get_tokenizer

    class IdText:
        non_speech_tokens = get_tokenizer(num_languages=99).non_speech_tokens

        def decode(self, ids):
            return " ".join(str(int(t)) for t in ids)

    cfg = get_config("tiny")
    rng = np.random.default_rng(16)
    clips = [(rng.standard_normal(16000 * s) * 0.1).astype(np.float32) for s in (3, 6, 2, 5)]
    langs = ["auto", "zh", "auto", "en"]

    def engine():
        return ContinuousBatchingEngine(
            init_params(cfg, seed=3, device="cpu").to_device(dev), IdText(), max_slots=4,
            compute_dtype=torch.float32, steps_per_sync=4, max_tokens=8, kv_quant=True,
            self_kv_quant=True, no_speech_threshold=None, logprob_threshold=None,
            compression_ratio_threshold=None)

    def run(eng, futs):
        for _ in range(40):
            if all(f.done() for f in futs):
                break
            eng._tick()
        return [f.result(0) for f in futs]

    eng = engine()
    futs = [eng.submit(Request(audio=c, language=lang)) for c, lang in zip(clips, langs)]
    eng._tick()  # admission: encode, detection, prefill, rows copied into slots 0-3
    prompts = eng.tokens[:, :4].cpu().numpy()
    for row, lang in zip(prompts, langs):
        if lang == "auto":
            assert 0 <= row[1] - cfg.lang_token_start < cfg.num_languages
        else:
            assert tuple(row) == cfg.sot_sequence(lang)
    mixed = run(eng, futs)
    assert all(r["language"] in LANGUAGES for r in mixed)
    assert [r["language"] for r in mixed][1::2] == ["zh", "en"]
    plain = engine()
    alone = run(plain, [plain.submit(Request(audio=clips[i], language=langs[i])) for i in (1, 3)])
    assert [r["text"] for r in alone] == [mixed[1]["text"], mixed[3]["text"]]


def test_segmented_turbo_encode_is_bit_equal(dev):
    """The serving engine's admission encode at turbo's full width (32
    layers, D 1280, W8A8, bf16, int8 cross-KV) for one bucket of 4 clips:
    split into 4 paced layer groups (``encode_chunks=4``) it gives the
    monolithic encode's cross-KV bit for bit, with the same launches. A
    layer quantizes its two LayerNorms' rows with K8n and the inputs of wo
    and w2 with K8q."""
    from whisper_tpu_torch.config import get_config
    from whisper_tpu_torch.ops.quant import quantize_params
    from whisper_tpu_torch.params import init_params
    from whisper_tpu_torch.serving.engine import ContinuousBatchingEngine, Request
    from whisper_tpu_torch.tokenizer import get_tokenizer

    cfg = get_config("turbo")
    model = quantize_params(init_params(cfg, seed=0, device=dev))
    eng = ContinuousBatchingEngine(model, get_tokenizer(num_languages=cfg.num_languages),
                                   max_slots=4, max_tokens=32, kv_quant=True, self_kv_quant=True,
                                   w8a8=True, encode_chunks=4)
    rng = np.random.default_rng(61)
    reqs = [Request(audio=(rng.standard_normal(16000 * s) * 0.1).astype(np.float32))
            for s in (3, 11, 29, 17)]
    counters = (flash_attention_btd, int8_gemm, quantize_rows, log10_mel, layer_norm_rows)
    runs = []
    for chunks in (4, 1):
        eng.encode_chunks = chunks
        before = [fn.launches for fn in counters]
        cross = eng._encode(reqs, 4)
        torch.cuda.synchronize()
        runs.append((cross, [fn.launches - b for fn, b in zip(counters, before)]))
    (seg, seg_launches), (mono, mono_launches) = runs
    assert len(eng._encode_seg_est[4]) == 4 and seg_launches == mono_launches
    assert seg_launches == [32, 6 * 32, 2 * 32, 1, 2 * 32]
    for a, b in zip(seg, mono):
        assert a.dtype == b.dtype and torch.equal(a, b)
