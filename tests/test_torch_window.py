"""Sliding-window attention in the port (starcoder2) against the JAX
package, on the CPU: the windowed masks, the windowed K9 op (its plain
version here) against the reference's ``_sdpa_chunked(..., window)``,
and reduced starcoder2-3b (window 16) through prefill on both attention
branches, decode past the window, greedy ``generate`` and the loss's
gradient above 512 tokens, in f32 and bf16, with the reference's own
``init_params(PRNGKey(0))`` weights carried across as numpy arrays;
the configs, ``param_shapes`` at full size and the input shapes of
starcoder2-3b and -15b. Tolerances as in ``test_torch_models.py``
(``_torch_lm``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_lm import (  # noqa: F401 (fixture)
    DTYPES,
    check_grads_against_reference,
    check_param_shapes_at_full_size,
    close,
    jax_decode,
    models,
    no_activation_sharder,
    tokens,
)
from _torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

import repro.models.common as jax_common
from repro.configs import get_config as jax_get_config
from repro.launch import shapes as jax_shapes
from repro.models.attention import _sdpa_chunked as jax_sdpa_chunked
from repro.models.transformer import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.configs import starcoder2_3b, starcoder2_15b
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_ref,
    gqa_flash_attention_ref,
)
from repro_torch.launch import shapes
from repro_torch.launch.serve import generate
from repro_torch.launch.steps import make_prefill, make_serve_step
from repro_torch.models import attention as port_attention
from repro_torch.models import build_model
from repro_torch.models.common import causal_mask, decode_mask
from repro_torch.tree import tree_leaves, tree_map

pytestmark = pytest.mark.usefixtures("no_activation_sharder")

ARCH = "starcoder2-3b"
PARAM_SHAPES = {"starcoder2-3b": starcoder2_3b.param_shapes,
                "starcoder2-15b": starcoder2_15b.param_shapes}


def _qkv(seed, b, t, h, kv, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t, h, hd), dtype=np.float32),
            rng.standard_normal((b, t, kv, hd), dtype=np.float32),
            rng.standard_normal((b, t, kv, hd), dtype=np.float32))


# -- masks ----------------------------------------------------------------------


@pytest.mark.parametrize("window", [None, 1, 5, 16, 300])
@pytest.mark.parametrize("t", [1, 37, 600])
def test_causal_mask_matches_reference(t, window):
    want = np.asarray(jax_common.causal_mask(t, window))
    np.testing.assert_array_equal(causal_mask(t, window).numpy(), want)


@pytest.mark.parametrize("window", [None, 1, 16])
def test_decode_mask_matches_reference(window):
    for pos in (0, 5, 15, 16, 17, 39):
        want = np.asarray(jax_common.decode_mask(40, jnp.int32(pos), window))
        np.testing.assert_array_equal(decode_mask(40, pos, window).numpy(),
                                      want)


# -- the windowed K9 op (its plain version on the CPU) --------------------------


@pytest.mark.parametrize("window", [16, 300])
@pytest.mark.parametrize("t", [600, 1030])
def test_windowed_flash_attention_matches_reference_chunked(t, window):
    """The op (the plain version on CPU tensors, no launch counted) equals
    the reference's windowed ``_sdpa_chunked`` on GQA inputs, f32 to
    1e-5."""
    q, k, v = _qkv(t + window, 2, t, 4, 2, 64)
    want = jax_sdpa_chunked(*(jnp.asarray(x) for x in (q, k, v)), n_rep=2,
                            window=window)
    before = dict(LAUNCHES)
    got = flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                          window=window)
    assert LAUNCHES == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_windowed_flash_attention_sees_only_its_window():
    """Keys and values outside query i's window (j <= i - window, and
    j > i) change nothing of its output, bit for bit; a window as wide as
    T is plain causal attention."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(4, 1, 300, 4, 2, 64))
    w, i = 37, 171
    out = flash_attention(q, k, v, window=w)
    k2, v2 = k.clone(), v.clone()
    k2[:, :i - w + 1] += 10.0
    v2[:, :i - w + 1] -= 10.0
    k2[:, i + 1:] += 10.0
    v2[:, i + 1:] -= 10.0
    out2 = flash_attention(q, k2, v2, window=w)
    assert torch.equal(out[:, i], out2[:, i])
    assert not torch.allclose(out[:, i + 1], out2[:, i + 1])
    assert not torch.allclose(out[:, i - 1], out2[:, i - 1])
    assert torch.equal(flash_attention(q, k, v, window=300),
                       flash_attention(q, k, v))


def test_windowed_plain_versions_agree():
    """The layout-level plain version is the folded oracle, window and all,
    head by head, bit for bit; window 1 is each query's own value."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(5, 2, 150, 6, 3, 64))
    got = gqa_flash_attention_ref(q, k, v, 20)
    for h in range(6):
        want = flash_attention_ref(q[:, :, h], k[:, :, h // 2],
                                   v[:, :, h // 2], 20)
        assert torch.equal(got[:, :, h], want)
    one = gqa_flash_attention_ref(q, k, v, 1)
    torch.testing.assert_close(one, v.repeat_interleave(2, dim=2))


@pytest.mark.parametrize("window", [0, -3, 2.5, True])
def test_flash_attention_rejects_bad_windows(window):
    q, k, v = (torch.from_numpy(x) for x in _qkv(6, 1, 64, 4, 2, 64))
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, k, v, window=window)


# -- configs and shapes ------------------------------------------------------------


@pytest.mark.parametrize("arch", ["starcoder2-3b", "starcoder2-15b"])
def test_config_matches_reference(arch):
    for smoke in (False, True):
        got, want = get_config(arch, smoke=smoke), jax_get_config(
            arch, smoke=smoke)
        for f in dataclasses.fields(got):
            assert getattr(got, f.name) == getattr(want, f.name), f.name
        assert got.hd == want.hd == (128 if not smoke else 64)
        assert got.sliding_window == (16 if smoke else 4096)
        assert got.supports_long_decode


@pytest.mark.parametrize("arch", ["starcoder2-3b", "starcoder2-15b"])
def test_param_shapes_match_reference_at_full_size(arch):
    """gelu MLP (no ``wg``), layernorm (``w`` and ``b``), an untied
    ``lm_head``: 14 leaves."""
    assert check_param_shapes_at_full_size(arch, PARAM_SHAPES[arch]) == 14
    got = PARAM_SHAPES[arch]()
    assert "wg" not in got["layers"][0]["ffn"] and "lm_head" in got
    assert set(got["norm_f"]) == {"w", "b"}


@pytest.mark.parametrize("arch", ["starcoder2-3b", "starcoder2-15b"])
def test_input_shapes_match_reference(arch):
    """skip_reason (none: the window makes long_500k run) and the decode
    stand-ins, leaf by leaf, for every assigned shape."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    model, jmodel = build_model(cfg), jax_build_model(jcfg)
    for name, shape in shapes.SHAPES.items():
        jshape = jax_shapes.SHAPES[name]
        assert shapes.skip_reason(cfg, shape) is None
        assert jax_shapes.skip_reason(jcfg, jshape) is None
        if shape.kind != "decode":
            continue
        got = shapes.decode_input_specs(cfg, shape, model)
        want = jax_shapes.decode_input_specs(jcfg, jshape, jmodel)
        pairs = []
        tree_map(lambda a, b: pairs.append((tuple(a.shape), tuple(b.shape),
                                            a.device.type)),
                 got["cache"], want["cache"])
        assert pairs and all(a == b and d == "meta" for a, b, d in pairs)
        assert len(pairs) == len(jax.tree.leaves(want["cache"]))
        assert tuple(got["token"].shape) == want["token"].shape


# -- reduced starcoder2-3b against the reference -----------------------------------


def test_init_params_tree_matches_param_shapes_and_reference():
    jmodel, jparams, model, _ = models(ARCH, "float32")
    params = model.init_params(torch.Generator().manual_seed(0))
    n = []

    def check(p, spec, ref):
        assert tuple(p.shape) == tuple(spec.shape) == tuple(ref.shape)
        assert p.dtype == spec.dtype == torch.float32
        n.append(1)

    tree_map(check, params, starcoder2_3b.param_shapes(model.cfg), jparams)
    assert len(n) == len(jax.tree.leaves(jparams)) == 14
    layer = params["layers"][0]
    assert not layer["norm1"]["b"].any() and not params["norm_f"]["b"].any()


@pytest.mark.parametrize("t", [64, 600])
@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_matches_reference(dtype, t):
    """T=64 runs ``_sdpa`` with the windowed mask on both sides; T=600
    runs the port's windowed K9 op against the reference's windowed
    ``_sdpa_chunked``. f32 to 1e-4, bf16 by the bf16 tolerance."""
    jmodel, jparams, model, params = models(ARCH, dtype)
    toks = tokens(t, 2, t, model.cfg.vocab)
    want, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(toks),
                                       "targets": jnp.asarray(toks)})
    got = make_prefill(model)(params, {"tokens": torch.from_numpy(toks).long()})
    assert got.shape == (2, t, model.cfg.vocab)
    close(got, want, dtype)


def test_prefill_passes_the_window_to_k9(monkeypatch):
    """Above 512 tokens the prefill calls the K9 op once per layer with
    the config's window."""
    _, _, model, params = models(ARCH, "float32")
    calls = []

    def spy(q, k, v, window=None):
        calls.append(window)
        return flash_attention(q, k, v, window=window)

    monkeypatch.setattr(port_attention, "flash_attention", spy)
    toks = torch.from_numpy(tokens(12, 1, 600, model.cfg.vocab)).long()
    make_prefill(model)(params, {"tokens": toks})
    assert calls == [16] * model.cfg.n_layers


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_past_the_window_matches_reference(dtype):
    """24 tokens through a cache of 28 with window 16: the last 8 steps
    see only the window."""
    jmodel, jparams, model, params = models(ARCH, dtype)
    toks = tokens(20, 2, 24, model.cfg.vocab)
    want = jax_decode(jmodel, jparams, toks, 28)
    serve = make_serve_step(model)
    cache = model.init_cache(2, 28, "cpu")
    for pos in range(24):
        lg, cache = serve(params, cache, torch.from_numpy(
            toks[:, pos:pos + 1]).long(), pos)
        close(lg[:, 0], want[pos], dtype)


def test_decode_matches_forward_through_k9_branch():
    """Teacher-forced forward logits (the windowed K9 branch at T=600)
    equal token-by-token decode logits (the windowed decode mask), to the
    reference's 2e-3."""
    _, _, model, params = models(ARCH, "float32")
    toks = torch.from_numpy(tokens(3, 1, 600, model.cfg.vocab)).long()
    fwd = make_prefill(model)(params, {"tokens": toks})
    serve = make_serve_step(model)
    cache = model.init_cache(1, 600, "cpu")
    for pos in range(600):
        lg, cache = serve(params, cache, toks[:, pos:pos + 1], pos)
        torch.testing.assert_close(lg[:, 0], fwd[:, pos], atol=2e-3, rtol=2e-3)


def test_generate_greedy_matches_reference_decode_loop():
    """20 greedy positions, past the window of 16: the port's tokens are
    the reference's argmax along them, f32."""
    jmodel, jparams, model, params = models(ARCH, "float32")
    prompt_len, n_gen = 8, 12
    seqs = generate(ARCH, smoke=True, batch=2, prompt_len=prompt_len,
                    gen=n_gen, seed=5, greedy=True, device="cpu",
                    params=params)
    assert seqs.shape == (2, prompt_len + n_gen)
    toks = seqs.numpy().astype(np.int32)
    logits = jax_decode(jmodel, jparams, toks[:, :-1], prompt_len + n_gen)
    for i in range(n_gen):
        np.testing.assert_array_equal(toks[:, prompt_len + i],
                                      logits[prompt_len - 1 + i].argmax(-1))


def test_loss_grad_matches_reference_above_512_tokens():
    """At T=600 both sides differentiate their windowed ``_sdpa_chunked``
    (no K9 under autograd)."""
    jmodel, jparams, model, params = models(ARCH, "float32")
    before = dict(LAUNCHES)
    n = check_grads_against_reference(jmodel, jparams, model, params,
                                      tokens(11, 2, 600, model.cfg.vocab))
    assert n == 14 and LAUNCHES == before
    assert len(tree_leaves(params)) == 14
