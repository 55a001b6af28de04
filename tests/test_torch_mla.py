"""Multi-head latent attention in the port (minicpm3-4b) against the JAX
package, on the CPU: ``mla_forward`` on one layer's weights at T <= 512
(``_mla_attend``) and above (``_mla_attend_chunked``), the chunked path
against the one-shot one, ``mla_decode`` with its latent cache, and the
reduced minicpm3-4b through prefill, decode, greedy ``generate`` and the
loss's gradient above 512 tokens, in f32 and bf16, with the reference's
own ``init_params(PRNGKey(0))`` weights carried across as numpy arrays;
the config, ``param_shapes`` at full size and the input shapes.
Tolerances as in ``test_torch_models.py`` (``_torch_lm``).
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

from repro.configs import get_config as jax_get_config
from repro.launch import shapes as jax_shapes
from repro.models import attention as jax_attention
from repro.models.transformer import build_model as jax_build_model
from repro_torch.configs import get_config, minicpm3_4b
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import LAUNCHES
from repro_torch.launch import shapes
from repro_torch.launch.serve import generate
from repro_torch.launch.steps import make_prefill, make_serve_step
from repro_torch.models import attention as port_attention
from repro_torch.models import build_model
from repro_torch.models.common import causal_mask
from repro_torch.tree import tree_map

pytestmark = pytest.mark.usefixtures("no_activation_sharder")

ARCH = "minicpm3-4b"


def _layer(dtype: str, seed: int = 1):
    """(reduced config, the reference's ``mla_init`` weights, the port's
    copy of them)."""
    jcfg = dataclasses.replace(jax_get_config(ARCH, smoke=True), dtype=dtype)
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype=dtype)
    jp = jax_attention.mla_init(jax.random.PRNGKey(seed), jcfg)
    p = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, cfg, jp, p


def _x(seed, b, t, d, dtype):
    x = np.random.default_rng(seed).standard_normal((b, t, d),
                                                    dtype=np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


# -- config and shapes ---------------------------------------------------------------


def test_config_matches_reference():
    for smoke in (False, True):
        got, want = get_config(ARCH, smoke=smoke), jax_get_config(
            ARCH, smoke=smoke)
        for f in dataclasses.fields(got):
            g, w = getattr(got, f.name), getattr(want, f.name)
            if f.name == "mla":
                g, w = dataclasses.asdict(g), dataclasses.asdict(w)
            assert g == w, f.name
    assert dataclasses.asdict(get_config(ARCH, smoke=True).mla) == dict(
        q_lora_rank=64, kv_lora_rank=32, qk_nope_dim=32, qk_rope_dim=16,
        v_head_dim=32)


def test_param_shapes_match_reference_at_full_size():
    """Seven MLA projections, swiglu, rmsnorm, tied embeddings: 14 leaves."""
    assert check_param_shapes_at_full_size(ARCH, minicpm3_4b.param_shapes) == 14
    got = minicpm3_4b.param_shapes()
    assert set(got["layers"][0]["mixer"]) == {"wdq", "wuq", "wdkv", "wkrope",
                                              "wuk", "wuv", "wo"}
    assert "lm_head" not in got


def test_input_shapes_match_reference():
    """long_500k is skipped for the reason the reference gives; the
    decode stand-ins are the latent cache, leaf by leaf."""
    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    model, jmodel = build_model(cfg), jax_build_model(jcfg)
    for name, shape in shapes.SHAPES.items():
        jshape = jax_shapes.SHAPES[name]
        assert shapes.skip_reason(cfg, shape) == jax_shapes.skip_reason(
            jcfg, jshape)
        if shape.kind != "decode" or shapes.skip_reason(cfg, shape):
            continue
        got = shapes.decode_input_specs(cfg, shape, model)
        want = jax_shapes.decode_input_specs(jcfg, jshape, jmodel)
        assert set(got["cache"]["blocks"][0]) == {"ckv", "krope"}
        pairs = []
        tree_map(lambda a, b: pairs.append((tuple(a.shape), tuple(b.shape),
                                            a.device.type)),
                 got["cache"], want["cache"])
        assert pairs and all(a == b and d == "meta" for a, b, d in pairs)
        assert len(pairs) == len(jax.tree.leaves(want["cache"]))
    assert shapes.skip_reason(cfg, shapes.SHAPES["long_500k"]) is not None


# -- one layer ------------------------------------------------------------------


@pytest.mark.parametrize("t", [64, 600])
@pytest.mark.parametrize("dtype", DTYPES)
def test_mla_forward_matches_reference(dtype, t):
    """T=64 through ``_mla_attend``, T=600 through ``_mla_attend_chunked``
    (a ragged last chunk) on both sides; the latent cache too."""
    jcfg, cfg, jp, p = _layer(dtype)
    jx, x = _x(t, 2, t, cfg.d_model, dtype)
    want, jc = jax_attention.mla_forward(jp, jx, jcfg)
    with torch.no_grad():
        got, c = port_attention.mla_forward(p, x, cfg)
    assert got.shape == (2, t, cfg.d_model) and got.dtype == x.dtype
    close(got, want, dtype, tol=1e-5)
    close(c["ckv"], jc["ckv"], dtype, tol=1e-5)
    close(c["krope"], jc["krope"], dtype, tol=1e-5)


def test_chunked_path_equals_the_full_mask():
    """Above 512 tokens the chunked path equals ``_mla_attend`` under the
    whole causal mask, f32 to 1e-6."""
    _, cfg, _, p = _layer("float32")
    _, x = _x(3, 1, 600, cfg.d_model, "float32")
    with torch.no_grad():
        q_nope, q_rope, ckv, krope = port_attention._mla_qk(
            p, x, torch.arange(600)[None], cfg)
        chunked = port_attention._mla_attend_chunked(p, q_nope, q_rope, ckv,
                                                     krope, cfg)
        full = port_attention._mla_attend(p, q_nope, q_rope, ckv, krope,
                                          causal_mask(600), cfg)
    torch.testing.assert_close(chunked, full, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mla_decode_matches_reference(dtype):
    """Token by token against the reference's ``mla_decode``; the port
    writes the latent cache in place."""
    jcfg, cfg, jp, p = _layer(dtype)
    jx, x = _x(4, 2, 12, cfg.d_model, dtype)
    jcache = jax_attention.mla_init_cache(jcfg, 2, 16)
    cache = port_attention.mla_init_cache(cfg, 2, 16, "cpu")
    assert cache["ckv"].shape == (2, 16, 32) and cache["krope"].shape == (
        2, 16, 16)
    ckv = cache["ckv"]
    for pos in range(12):
        want, jcache = jax_attention.mla_decode(jp, jx[:, pos:pos + 1],
                                                jcache, pos, jcfg)
        got, cache = port_attention.mla_decode(p, x[:, pos:pos + 1], cache,
                                               pos, cfg)
        close(got, want, dtype, tol=1e-5)
    assert cache["ckv"] is ckv
    close(cache["ckv"], jcache["ckv"], dtype, tol=1e-5)
    close(cache["krope"], jcache["krope"], dtype, tol=1e-5)


# -- reduced minicpm3-4b against the reference ------------------------------------


def test_init_params_tree_matches_param_shapes_and_reference():
    jmodel, jparams, model, _ = models(ARCH, "float32")
    params = model.init_params(torch.Generator().manual_seed(0))
    n = []

    def check(got, spec, ref):
        assert tuple(got.shape) == tuple(spec.shape) == tuple(ref.shape)
        assert got.dtype == spec.dtype == torch.float32
        n.append(1)

    tree_map(check, params, minicpm3_4b.param_shapes(model.cfg), jparams)
    assert len(n) == len(jax.tree.leaves(jparams)) == 14


@pytest.mark.parametrize("t", [64, 600])
@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_matches_reference(dtype, t):
    jmodel, jparams, model, params = models(ARCH, dtype)
    toks = tokens(t, 2, t, model.cfg.vocab)
    want, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(toks),
                                       "targets": jnp.asarray(toks)})
    before = dict(LAUNCHES)
    got = make_prefill(model)(params, {"tokens": torch.from_numpy(toks).long()})
    assert LAUNCHES == before
    assert got.shape == (2, t, model.cfg.vocab)
    close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_step_matches_reference(dtype):
    jmodel, jparams, model, params = models(ARCH, dtype)
    toks = tokens(20, 2, 20, model.cfg.vocab)
    want = jax_decode(jmodel, jparams, toks, 24)
    serve = make_serve_step(model)
    cache = model.init_cache(2, 24, "cpu")
    assert set(cache["blocks"][0]) == {"ckv", "krope"}
    for pos in range(20):
        lg, cache = serve(params, cache, torch.from_numpy(
            toks[:, pos:pos + 1]).long(), pos)
        close(lg[:, 0], want[pos], dtype)


def test_decode_matches_forward_through_chunked_branch():
    """Teacher-forced forward logits at T=600 (the chunked path) equal
    token-by-token decode logits, to the reference's 2e-3."""
    _, _, model, params = models(ARCH, "float32")
    toks = torch.from_numpy(tokens(3, 1, 600, model.cfg.vocab)).long()
    fwd = make_prefill(model)(params, {"tokens": toks})
    serve = make_serve_step(model)
    cache = model.init_cache(1, 600, "cpu")
    for pos in range(600):
        lg, cache = serve(params, cache, toks[:, pos:pos + 1], pos)
        torch.testing.assert_close(lg[:, 0], fwd[:, pos], atol=2e-3, rtol=2e-3)


def test_generate_greedy_matches_reference_decode_loop():
    jmodel, jparams, model, params = models(ARCH, "float32")
    prompt_len, n_gen = 8, 12
    seqs = generate(ARCH, smoke=True, batch=2, prompt_len=prompt_len,
                    gen=n_gen, seed=5, greedy=True, device="cpu",
                    params=params)
    toks = seqs.numpy().astype(np.int32)
    logits = jax_decode(jmodel, jparams, toks[:, :-1], prompt_len + n_gen)
    for i in range(n_gen):
        np.testing.assert_array_equal(toks[:, prompt_len + i],
                                      logits[prompt_len - 1 + i].argmax(-1))


def test_loss_grad_matches_reference_above_512_tokens():
    """At T=600 both sides differentiate their chunked MLA (checkpointed
    query chunks)."""
    jmodel, jparams, model, params = models(ARCH, "float32")
    n = check_grads_against_reference(jmodel, jparams, model, params,
                                      tokens(11, 2, 600, model.cfg.vocab))
    assert n == 14
