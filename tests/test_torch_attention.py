"""The port's two kernel modules against the JAX Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; it is held against
the Pallas kernel in interpret mode at the tolerances of
tests/test_pallas.py. The hand-written kernels are held against the plain
versions on the card by tests/test_torch_kernels_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.models.model import attention_int8kv as jax_attention_int8kv
from whisper_tpu.models.model import quantize_cross_kv as jax_quantize_cross_kv
from whisper_tpu.ops.decode_attention import cross_attention_decode_fd as jax_fd
from whisper_tpu.ops.flash_attention import flash_attention_btd as jax_btd
from whisper_tpu_torch.models.model import attention_int8kv
from whisper_tpu_torch.ops.decode_attention import cross_attention_decode_fd
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


def test_wrappers_refuse_other_devices():
    meta = torch.empty((1, 8, 128), device="meta")
    with pytest.raises(ValueError):
        flash_attention_btd(meta, meta, meta, 2)
    with pytest.raises(ValueError):
        cross_attention_decode_fd(torch.empty((1, 2, 1, 64), device="meta"), *([meta] * 4))
