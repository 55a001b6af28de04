"""The port's causal attention op ``flash_attention`` (K9) against the
JAX package, on the CPU, where the op runs its plain version.

The reference's own Pallas kernel does not trace on this JAX (ROADMAP
Queue C, ``pl.load``), so the port is held to the reference's oracle
``flash_attention_ref`` and to the model's chunked XLA attention
``_sdpa_chunked``, the path the JAX package names as flash attention's
counterpart. Inputs are numpy draws from a seed, handed to both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import one_torch_thread  # noqa: F401

from repro.kernels.flash_attention import flash_attention_ref as jax_flash_ref
from repro.models.attention import _sdpa_chunked
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_ref,
    gqa_flash_attention_ref,
)

BF16_STEP = 2.0 ** -7   # one bf16 rounding step, relative to the value


def _qkv(seed, b, t, h, kv, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t, h, hd), dtype=np.float32),
            rng.standard_normal((b, t, kv, hd), dtype=np.float32),
            rng.standard_normal((b, t, kv, hd), dtype=np.float32))


def _fold(x):
    b, t, h, hd = x.shape
    return x.transpose(0, 2, 1, 3).reshape(b * h, t, hd)


def _reference(q, k, v, dtype):
    """The reference's oracle on folded inputs, KV heads pre-expanded
    (head h reads KV head h // (H / KV)), unfolded to (B, T, H, hd)."""
    b, t, h, hd = q.shape
    n_rep = h // k.shape[2]
    k, v = np.repeat(k, n_rep, axis=2), np.repeat(v, n_rep, axis=2)
    out = jax_flash_ref(*(jnp.asarray(_fold(x), dtype) for x in (q, k, v)))
    out = np.asarray(out.astype(jnp.float32))
    return out.reshape(b, h, t, hd).transpose(0, 2, 1, 3)


def _port(q, k, v, dtype):
    out = flash_attention(*(torch.from_numpy(x).to(dtype) for x in (q, k, v)))
    assert out.dtype == dtype and out.shape == q.shape
    return out.float().numpy()


def _close(got, want, dtype):
    """f32 to 1e-5; bf16 within one bf16 rounding step of the reference
    (both compute in f32 and round the output once), plus 1e-6 absolute
    for outputs near 0, where the f32 sums' error exceeds a step."""
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert np.all(np.abs(got - want) <= BF16_STEP * np.abs(want) + 1e-6)


@pytest.mark.parametrize("t", [128, 200, 600])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_matches_reference_oracle(dtype, t):
    q, k, v = _qkv(t, 2, t, 3, 3, 64)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    _close(_port(q, k, v, dtype), _reference(q, k, v, jdt), dtype)


@pytest.mark.parametrize("t,h,kv", [(200, 4, 2), (600, 14, 2), (130, 6, 1)])
def test_flash_attention_gqa_matches_expanded_reference(t, h, kv):
    q, k, v = _qkv(7 + t, 1, t, h, kv, 64)
    _close(_port(q, k, v, torch.float32), _reference(q, k, v, jnp.float32),
           torch.float32)


def test_flash_attention_is_causal():
    """Changing the keys and values after position t leaves every output
    at positions <= t unchanged, bit for bit."""
    q, k, v = _qkv(3, 1, 300, 4, 2, 64)
    out1 = _port(q, k, v, torch.float32)
    k2, v2 = k.copy(), v.copy()
    k2[:, 171:] += 10.0
    v2[:, 171:] -= 10.0
    out2 = _port(q, k2, v2, torch.float32)
    np.testing.assert_array_equal(out1[:, :171], out2[:, :171])
    assert not np.allclose(out1[:, 171:], out2[:, 171:])


@pytest.mark.parametrize("t,chunk", [(600, 256), (320, 128)])
def test_flash_attention_matches_model_chunked_path(t, chunk):
    """The op equals the JAX model's long-sequence attention on the same
    GQA inputs (groups not expanded), to the reference's own 3e-5."""
    q, k, v = _qkv(11 + t, 2, t, 4, 2, 64)
    want = _sdpa_chunked(*(jnp.asarray(x) for x in (q, k, v)), n_rep=2,
                         window=None, chunk=chunk)
    np.testing.assert_allclose(_port(q, k, v, torch.float32),
                               np.asarray(want), atol=3e-5, rtol=3e-5)


def test_gqa_plain_version_is_the_folded_oracle():
    """The layout-level plain version is the folded oracle with KV heads
    expanded: the same numbers bit for bit, head by head."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(5, 2, 150, 6, 3, 64))
    got = gqa_flash_attention_ref(q, k, v)
    for h in range(6):
        want = flash_attention_ref(q[:, :, h], k[:, :, h // 2], v[:, :, h // 2])
        assert torch.equal(got[:, :, h], want)


def test_flash_attention_cpu_path_counts_no_launch_and_checks_inputs():
    q, k, v = (torch.from_numpy(x) for x in _qkv(6, 1, 64, 4, 2, 64))
    before = dict(LAUNCHES)
    flash_attention(q, k, v)
    assert LAUNCHES == before
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention(q.clone().requires_grad_(), k, v)
    with pytest.raises(ValueError, match="KV heads must divide H"):
        k3 = k[:, :, :1].expand(1, 64, 3, 64)
        flash_attention(q, k3, k3)
    with pytest.raises(ValueError, match="KV heads must divide H"):
        flash_attention(q[:, :, :3], k, v)
    with pytest.raises(ValueError, match="tiles"):
        flash_attention(q, k, v, bq=96)
