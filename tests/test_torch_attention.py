"""The port's kernel modules against the JAX Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; it is held against
the Pallas kernel in interpret mode at the tolerances of
tests/test_pallas.py. The hand-written kernels are held against the plain
versions on the card by tests/test_torch_kernels_cuda.py.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.models.model import attention_int8kv as jax_attention_int8kv
from whisper_tpu.models.model import attention_int8kv_perpos as jax_perpos
from whisper_tpu.models.model import attention_kvt as jax_attention_kvt
from whisper_tpu.models.model import quantize_cross_kv as jax_quantize_cross_kv
from whisper_tpu.models.model import quantize_kv_heads as jax_quantize_kv_heads
from whisper_tpu.ops.decode_attention import cross_attention_decode_fd as jax_fd
from whisper_tpu.ops.decode_attention import self_attention_decode as jax_self_decode
from whisper_tpu.ops.flash_attention import flash_attention_btd as jax_btd
from whisper_tpu_torch.models.model import attention_int8kv
from whisper_tpu_torch.ops.decode_attention import (
    cross_attention_decode_fd,
    self_attention_decode,
    self_attention_decode_int8,
)
from whisper_tpu_torch.ops.flash_attention import flash_attention_btd

torch.set_num_threads(2)


def _btd_inputs(seed, B=2, T=150, D=128):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, T, D)).astype(np.float32) for _ in range(3)]


def _fd_inputs(seed, B=2, H=3, T=300, dh=64):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, 1, dh)).astype(np.float32)
    ck = rng.standard_normal((1, B, H, T, dh)).astype(np.float32)
    cv = rng.standard_normal((1, B, H, T, dh)).astype(np.float32)
    return q, ck, cv


def test_flash_attention_btd_matches_pallas():
    """B=2, T=150 (a ragged last q tile of 22 at q_tile=64), D=128, H=2."""
    q, k, v = _btd_inputs(0)
    ref = np.asarray(jax_btd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 2,
                             interpret=True, q_tile=64))
    before = flash_attention_btd.launches
    got = flash_attention_btd(*(torch.from_numpy(x) for x in (q, k, v)), 2)
    assert flash_attention_btd.launches == before  # the plain version is no launch
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-4, atol=2e-4)


def test_cross_attention_decode_fd_matches_pallas_and_int8kv():
    """B=2, H=3, T=300 (a ragged tail of 44 at t_tile=128), dh=64."""
    q, ck, cv = _fd_inputs(1)
    jq = jax_quantize_cross_kv((jnp.asarray(ck), jnp.asarray(cv)))
    jargs = (jnp.asarray(q), jq[0][0], jq[1][0], jq[2][0], jq[3][0])
    ref_fd = np.asarray(jax_fd(*jargs, interpret=True, t_tile=128))
    ref_xla = np.asarray(jax_attention_int8kv(*jargs))

    targs = (torch.from_numpy(q),) + tuple(torch.from_numpy(np.array(a)) for a in jargs[1:])
    before = cross_attention_decode_fd.launches
    got = cross_attention_decode_fd(*targs)
    assert cross_attention_decode_fd.launches == before
    assert got.shape == (2, 3, 1, 64)
    np.testing.assert_allclose(got.numpy(), ref_fd, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got.numpy(), ref_xla, rtol=2e-3, atol=2e-3)
    # the port's own einsum path agrees with the JAX one too
    np.testing.assert_allclose(attention_int8kv(*targs).numpy(), ref_xla, rtol=2e-4, atol=2e-4)


def _self_inputs(seed, B=4, H=3, T=32, dh=64):
    """q (B, H, 1, dh); k, v (B, H, T, dh) in the TPU kernel's layout."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, 1, dh)).astype(np.float32)
    k = rng.standard_normal((B, H, T, dh)).astype(np.float32)
    v = rng.standard_normal((B, H, T, dh)).astype(np.float32)
    return q, k, v


# ragged per-row offsets (0 = one visible key, T-1 = all) and a scalar
OFFSETS = [np.array([0, 5, 31, 17]), 9]
SELF_TOL = 1e-5  # fp32 on both sides; sums in another order


@pytest.mark.parametrize("offsets", OFFSETS, ids=["ragged", "scalar"])
def test_self_attention_decode_matches_pallas(offsets):
    """The float-cache entry point, fed the port's position-minor cache,
    against the Pallas kernel (interpret mode) fed the same cache in its
    (B, H, T, dh) layout."""
    q, k, v = _self_inputs(2)
    ref = np.asarray(jax_self_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     jnp.asarray(offsets, jnp.int32), interpret=True))
    toff = torch.from_numpy(offsets) if isinstance(offsets, np.ndarray) else offsets
    before = self_attention_decode.launches
    got = self_attention_decode(torch.from_numpy(q), torch.from_numpy(k.swapaxes(-1, -2).copy()),
                                torch.from_numpy(v.swapaxes(-1, -2).copy()), toff)
    assert self_attention_decode.launches == before  # the plain version is no launch
    assert got.shape == ref.shape == (4, 3, 1, 64)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=SELF_TOL)


def _vis(offsets, pads, B, T):
    key = np.arange(T)[None, :]
    vis = key <= np.broadcast_to(np.asarray(offsets), (B,))[:, None]
    if pads is not None:
        vis &= key >= pads[:, None]
    return vis[:, None, None, :]


@pytest.mark.parametrize("use_pads", [False, True], ids=["nopad", "pad"])
@pytest.mark.parametrize("offsets", OFFSETS, ids=["ragged", "scalar"])
def test_self_attention_decode_matches_model_attention(offsets, use_pads):
    """Both entry points against the JAX decode step's own attentions,
    attention_kvt (float cache) and attention_int8kv_perpos (int8 cache,
    quantized by the JAX quantize_kv_heads), under the same mask."""
    q, k, v = _self_inputs(3)
    B, T = 4, 32
    pads = np.array([0, 2, 7, 17]) if use_pads else None
    mask = jnp.asarray(_vis(offsets, pads, B, T))
    toff = torch.from_numpy(offsets) if isinstance(offsets, np.ndarray) else offsets
    tpads = torch.from_numpy(pads) if use_pads else None
    k_t, v_t = k.swapaxes(-1, -2).copy(), v.swapaxes(-1, -2).copy()

    ref = np.asarray(jax_attention_kvt(jnp.asarray(q), jnp.asarray(k_t), jnp.asarray(v_t),
                                       mask=mask))
    got = self_attention_decode(torch.from_numpy(q), torch.from_numpy(k_t),
                                torch.from_numpy(v_t), toff, tpads)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=SELF_TOL)

    kv_q, kv_s = jax_quantize_kv_heads(jnp.asarray(k), jnp.asarray(v))
    ref8 = np.asarray(jax_perpos(jnp.asarray(q), kv_q, kv_s, mask=mask))
    before = self_attention_decode_int8.launches
    got8 = self_attention_decode_int8(torch.from_numpy(q), torch.from_numpy(np.array(kv_q)),
                                      torch.from_numpy(np.array(kv_s)), toff, tpads)
    assert self_attention_decode_int8.launches == before
    np.testing.assert_allclose(got8.numpy(), ref8, rtol=0, atol=SELF_TOL)


def test_wrappers_refuse_other_devices():
    meta = torch.empty((1, 8, 128), device="meta")
    with pytest.raises(ValueError):
        flash_attention_btd(meta, meta, meta, 2)
    with pytest.raises(ValueError):
        cross_attention_decode_fd(torch.empty((1, 2, 1, 64), device="meta"), *([meta] * 4))
    q = torch.empty((1, 2, 1, 64), device="meta")
    with pytest.raises(ValueError):
        self_attention_decode(q, meta, meta, 0)
    with pytest.raises(ValueError):
        self_attention_decode_int8(q, meta, meta, 0)


@pytest.mark.parametrize("B", [8, 4], ids=["serving", "longform"])
def test_cross_attention_decode_fd_matches_pallas_at_the_path_shapes(B):
    """The serving (8 slots) and long-form (4 windows) batches of turbo's
    decode step: H=20, T=1500 (three t_tiles of 512, the last ragged)."""
    q, ck, cv = _fd_inputs(10 + B, B=B, H=20, T=1500)
    jq = jax_quantize_cross_kv((jnp.asarray(ck), jnp.asarray(cv)))
    jargs = (jnp.asarray(q), jq[0][0], jq[1][0], jq[2][0], jq[3][0])
    ref_fd = np.asarray(jax_fd(*jargs, interpret=True))
    ref_xla = np.asarray(jax_attention_int8kv(*jargs))
    targs = (torch.from_numpy(q),) + tuple(torch.from_numpy(np.array(a)) for a in jargs[1:])
    got = cross_attention_decode_fd(*targs)
    assert got.shape == (B, 20, 1, 64)
    np.testing.assert_allclose(got.numpy(), ref_fd, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got.numpy(), ref_xla, rtol=2e-3, atol=2e-3)


# the serving (8 slots, T 256, offsets 4..227) and long-form (T 384, offsets
# 226..289, pads 0..60) windows of the decode step
PATH_WINDOWS = {"serving": (8, 256, 4, 227, None), "longform": (8, 384, 226, 289, 60)}


@pytest.mark.parametrize("path", list(PATH_WINDOWS))
def test_self_attention_decode_matches_jax_at_the_path_shapes(path):
    """Both entry points at H=20 and the path's cache length: against the
    Pallas kernel (interpret mode; it takes no pads) without pads, and
    against the JAX decode step's attention_kvt / attention_int8kv_perpos
    under the same mask with the path's pads."""
    B, T, lo, hi, max_pad = PATH_WINDOWS[path]
    rng = np.random.default_rng(T)
    q, k, v = _self_inputs(T, B=B, H=20, T=T)
    offsets = rng.integers(lo, hi + 1, B)
    toff = torch.from_numpy(offsets)
    k_t, v_t = k.swapaxes(-1, -2).copy(), v.swapaxes(-1, -2).copy()
    tq, tk, tv = torch.from_numpy(q), torch.from_numpy(k_t), torch.from_numpy(v_t)

    ref = np.asarray(jax_self_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     jnp.asarray(offsets, jnp.int32), interpret=True))
    np.testing.assert_allclose(self_attention_decode(tq, tk, tv, toff).numpy(), ref,
                               rtol=0, atol=SELF_TOL)

    pads = rng.integers(0, (max_pad or T // 4) + 1, B)
    mask = jnp.asarray(_vis(offsets, pads, B, T))
    ref = np.asarray(jax_attention_kvt(jnp.asarray(q), jnp.asarray(k_t), jnp.asarray(v_t),
                                       mask=mask))
    got = self_attention_decode(tq, tk, tv, toff, torch.from_numpy(pads))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=SELF_TOL)
    kv_q, kv_s = jax_quantize_kv_heads(jnp.asarray(k), jnp.asarray(v))
    ref8 = np.asarray(jax_perpos(jnp.asarray(q), kv_q, kv_s, mask=mask))
    got8 = self_attention_decode_int8(tq, torch.from_numpy(np.array(kv_q)),
                                      torch.from_numpy(np.array(kv_s)), toff,
                                      torch.from_numpy(pads))
    np.testing.assert_allclose(got8.numpy(), ref8, rtol=0, atol=SELF_TOL)


def _int8_convert_constants():
    """kMagic, kBias, kFlip and kSelect as the decode kernels' header states them."""
    text = (Path(__file__).resolve().parents[1] / "whisper_tpu_torch" / "csrc"
            / "decode_common.cuh").read_text()
    got = {name: re.search(rf"constexpr \w+ {name} = ([0-9A-Fa-fx.]+?)u?f?;", text).group(1)
           for name in ("kMagic", "kBias", "kFlip", "kSelect")}
    return (int(got["kMagic"], 16), float(got["kBias"]), int(got["kFlip"], 16),
            int(got["kSelect"], 16))


def _byte_perm(x: np.ndarray, y: int, s: int) -> np.ndarray:
    """CUDA's __byte_perm(x, y, s): result byte n is byte (s >> 4n) & 7 of
    the eight bytes y:x (x's bytes 0-3, y's 4-7)."""
    pool = [(x >> (8 * i)) & 0xFF for i in range(4)] + [
        np.full_like(x, (y >> (8 * i)) & 0xFF) for i in range(4)]
    return sum(pool[(s >> (4 * n)) & 7] << (8 * n) for n in range(4)).astype(np.uint32)


def test_int8_to_fp32_bit_trick_is_exact_for_every_byte():
    """The kernels' int8 -> fp32 conversion (a byte permute of x ^ 0x80 into
    2^23's mantissa, minus 2^23 + 128), emulated bit for bit in numpy: all
    256 values, in each of the four byte lanes of a word."""
    magic, bias, flip, select = _int8_convert_constants()
    assert (magic, bias, flip, select) == (0x4B000000, 8388736.0, 0x80808080, 0x7440)
    x = np.arange(-128, 128, dtype=np.int8)
    for lane in range(4):
        word = (x.view(np.uint8).astype(np.uint32) << (8 * lane)) | (0x5A << (8 * ((lane + 1) % 4)))
        bits = _byte_perm(word ^ np.uint32(flip), magic, select + lane)
        got = bits.view(np.float32) - np.float32(bias)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, x.astype(np.float32))
