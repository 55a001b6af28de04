"""The port's dense decoder (reduced qwen2-0.5B) against the JAX package's,
on the CPU: config, the init tree, the prefill forward on both attention
branches (``_sdpa`` at T <= 512, the K9 op against the reference's
``_sdpa_chunked`` above), the gradient of the loss above 512 tokens
(the port's ``_sdpa_chunked`` against ``jax.grad`` through the
reference's), single-token decode and greedy ``generate``, in f32 and
bf16, with the reference's own ``init_params(PRNGKey(0))`` weights
carried across as numpy arrays.

bf16 tolerance: the two frameworks round bf16 at other places (XLA:CPU
computes a chain of bf16 elementwise ops in f32 and rounds once, PyTorch
rounds after each op), so the logits drift by a few bf16 steps; they
must agree within 4 steps of the largest logit, 4 * 2^-7 * max |logit|.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import one_torch_thread  # noqa: F401

import repro.models.common as jax_common
from repro.configs import get_config as jax_get_config
from repro.launch.steps import make_serve_step as jax_make_serve_step
from repro.models.transformer import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.configs.qwen2_0_5b import param_shapes
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import LAUNCHES
from repro_torch.launch.serve import generate
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch.steps import make_prefill, make_serve_step
from repro_torch.models import attention as port_attention
from repro_torch.models import build_model
from repro_torch.models.config import require_ported
from repro_torch.tree import tree_map

DTYPES = ["float32", "bfloat16"]
BF16_STEPS = 4 * 2.0 ** -7


@pytest.fixture(autouse=True)
def no_activation_sharder():
    """Run the JAX model without a mesh sharder, and leave none: a test
    elsewhere on the same worker may leave one (the reference's
    ``launch.train.train`` called in process does), and the reference's
    tests that run after expect none."""
    jax_common.set_activation_sharder(None, None)
    yield
    jax_common.set_activation_sharder(None, None)


@functools.lru_cache(maxsize=None)
def _models(dtype: str):
    """(JAX model, JAX params, port model, port params) of reduced qwen2
    in ``dtype``, the port's params copied from the reference's."""
    jcfg = dataclasses.replace(jax_get_config("qwen2-0.5b", smoke=True),
                               dtype=dtype)
    cfg = dataclasses.replace(get_config("qwen2-0.5b", smoke=True), dtype=dtype)
    jmodel = jax_build_model(jcfg, use_remat=False)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return jmodel, jparams, build_model(cfg), params


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, dtype: str):
    got, want = _np(got), _np(want)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        gap = float(np.max(np.abs(got - want)))
        assert gap <= BF16_STEPS * float(np.max(np.abs(want))), gap


def _tokens(seed: int, b: int, t: int, vocab: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (b, t)).astype(np.int32)


def test_config_matches_reference():
    for smoke in (False, True):
        got = get_config("qwen2-0.5b", smoke=smoke)
        want = jax_get_config("qwen2-0.5b", smoke=smoke)
        for f in dataclasses.fields(got):
            assert getattr(got, f.name) == getattr(want, f.name), f.name
        assert got.hd == want.hd
    small = get_config("qwen2-0.5b", smoke=True)
    assert (small.n_layers, small.d_model, small.n_heads, small.kv_heads,
            small.d_ff, small.vocab, small.dtype) == (2, 256, 4, 2, 512, 512,
                                                      "float32")
    assert dataclasses.replace(small, head_dim=32).hd == 32


def test_unported_configs_raise():
    """What stays outside the port is what the reference lacks: an
    unknown arch, and a family or attention type it does not have."""
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-5")
    cfg = get_config("qwen2-0.5b", smoke=True)
    for change in (dict(family="diffusion"), dict(attn_type="linear")):
        with pytest.raises(NotImplementedError, match="model zoo"):
            require_ported(dataclasses.replace(cfg, **change))
        with pytest.raises(NotImplementedError, match="model zoo"):
            build_model(dataclasses.replace(cfg, **change))


@pytest.mark.parametrize("dtype", DTYPES)
def test_init_params_tree_matches_param_shapes_and_reference(dtype):
    """The port's drawn tree has the paths, shapes and dtype of
    ``param_shapes()`` and of the reference's ``init_params``, and the
    reference's init laws (norms ones, biases zeros, N(0, 0.02)
    embeddings, dense std scale / sqrt(d_in))."""
    jmodel, jparams, model, _ = _models(dtype)
    cfg = model.cfg
    params = model.init_params(torch.Generator().manual_seed(0))
    want_dtype = torch.float32 if dtype == "float32" else torch.bfloat16
    shapes = []

    def check(p, spec, ref):
        assert tuple(p.shape) == tuple(spec.shape) == tuple(ref.shape)
        assert p.dtype == spec.dtype == want_dtype
        assert str(ref.dtype) == dtype
        shapes.append(p.shape)

    tree_map(check, params, param_shapes(cfg), jparams)
    assert len(shapes) == len(jax.tree.leaves(jparams)) == 14
    layer = params["layers"][0]
    for w in (params["norm_f"]["w"], layer["norm1"]["w"], layer["norm2"]["w"]):
        assert torch.equal(w, torch.ones_like(w))
    for name in ("bq", "bk", "bv"):
        assert not layer["mixer"][name].any()
    d, n = cfg.d_model, cfg.n_layers
    for w, std in ((params["embed"], 0.02),
                   (layer["mixer"]["wq"], d ** -0.5),
                   (layer["ffn"]["wo"], cfg.d_ff ** -0.5 / (2 * n) ** 0.5)):
        assert abs(float(w.float().std()) / std - 1.0) < 0.05


@pytest.mark.parametrize("t", [32, 600])
@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_matches_reference(dtype, t):
    """T=32 runs ``_sdpa`` on both sides; T=600 runs the port's K9 op
    against the reference's ``_sdpa_chunked``. f32 to 1e-4."""
    jmodel, jparams, model, params = _models(dtype)
    toks = _tokens(t, 2, t, model.cfg.vocab)
    want, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(toks),
                                       "targets": jnp.asarray(toks)})
    got = make_prefill(model)(params, {"tokens": torch.from_numpy(toks).long()})
    assert got.shape == (2, t, model.cfg.vocab)
    _close(got, want, dtype)
    if dtype == "float32":
        jloss = jmodel.loss_fn(jparams, {"tokens": jnp.asarray(toks),
                                         "targets": jnp.asarray(toks[:, ::-1])})
        loss = model.loss_fn(params, {"tokens": torch.from_numpy(toks).long(),
                                      "targets": torch.from_numpy(
                                          toks[:, ::-1].copy()).long()})
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)


def _jax_decode(jmodel, jparams, toks: np.ndarray, max_len: int) -> list:
    """Logits (B, V) of the reference's serve step, token by token."""
    serve = jax.jit(jax_make_serve_step(jmodel))
    cache = jmodel.init_cache(toks.shape[0], max_len)
    out = []
    for pos in range(toks.shape[1]):
        lg, cache = serve(jparams, cache, jnp.asarray(toks[:, pos:pos + 1]),
                          jnp.asarray(pos, jnp.int32))
        out.append(_np(lg[:, 0]))
    return out


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_step_matches_reference(dtype):
    jmodel, jparams, model, params = _models(dtype)
    toks = _tokens(20, 2, 20, model.cfg.vocab)
    want = _jax_decode(jmodel, jparams, toks, 24)
    serve = make_serve_step(model)
    cache = model.init_cache(2, 24, "cpu")
    for pos in range(20):
        lg, cache = serve(params, cache, torch.from_numpy(toks[:, pos:pos + 1])
                          .long(), pos)
        assert lg.shape == (2, 1, model.cfg.vocab)
        _close(lg[:, 0], want[pos], dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_generate_greedy_matches_reference_decode_loop(dtype):
    """The port's greedy tokens are the reference's on the same prompt:
    in f32 exactly (the reference's own decode loop, fed the port's
    prompt); in bf16 each port token is a greedy choice of the reference
    within the bf16 tolerance, teacher-forced along the port's tokens."""
    jmodel, jparams, model, params = _models(dtype)
    prompt_len, n_gen = 8, 12
    seqs = generate("qwen2-0.5b", smoke=True, batch=3, prompt_len=prompt_len,
                    gen=n_gen, seed=5, greedy=True, device="cpu",
                    params=params)
    assert seqs.shape == (3, prompt_len + n_gen) and seqs.dtype == torch.int64
    toks = seqs.numpy().astype(np.int32)
    logits = _jax_decode(jmodel, jparams, toks[:, :-1], prompt_len + n_gen)
    for i in range(n_gen):
        lg, chosen = logits[prompt_len - 1 + i], toks[:, prompt_len + i]
        if dtype == "float32":
            np.testing.assert_array_equal(chosen, lg.argmax(-1))
        else:
            picked = lg[np.arange(3), chosen]
            slack = BF16_STEPS * np.abs(lg).max()
            assert np.all(picked >= lg.max(-1) - slack)


def test_decode_matches_forward_through_k9_branch():
    """Teacher-forced forward logits (the K9 branch at T=600) equal
    token-by-token decode logits, the reference's
    ``test_decode_matches_forward`` on the port alone, to its 2e-3."""
    _, _, model, params = _models("float32")
    toks = torch.from_numpy(_tokens(3, 2, 600, model.cfg.vocab)).long()
    fwd = make_prefill(model)(params, {"tokens": toks})
    serve = make_serve_step(model)
    cache = model.init_cache(2, 600, "cpu")
    for pos in range(600):
        lg, cache = serve(params, cache, toks[:, pos:pos + 1], pos)
        torch.testing.assert_close(lg[:, 0], fwd[:, pos], atol=2e-3, rtol=2e-3)


def test_entry_points_default_to_the_card():
    """With no device the entry points ask for CUDA: without a card they
    raise, and no kernel launch is counted on the CPU path."""
    _, _, model, params = _models("float32")
    before = dict(LAUNCHES)
    make_prefill(model)(params, {"tokens": torch.zeros((1, 600), dtype=torch.long)})
    assert LAUNCHES == before
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        generate("qwen2-0.5b", smoke=True, batch=1, prompt_len=2, gen=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model.init_cache(1, 4)


def _grad_leaves(params) -> dict:
    """Copies of ``params`` that require grad (the cached tree is shared
    by the other tests and stays as it is)."""
    return tree_map(lambda a: a.detach().clone().requires_grad_(True), params)


def test_loss_grad_matches_reference_above_512_tokens():
    """At T=600 the reference differentiates ``_sdpa_chunked`` (query
    chunks of 256 under ``jax.checkpoint``); the port takes its own
    ``_sdpa_chunked`` while autograd records. Each leaf's gradient agrees
    within 1e-4 of the leaf's largest |grad| (f32; the sums of the two
    frameworks run in other orders)."""
    jmodel, jparams, model, params = _models("float32")
    toks = _tokens(11, 2, 600, model.cfg.vocab)
    targets = toks[:, ::-1].copy()
    jgrads = jax.grad(jmodel.loss_fn)(jparams, {
        "tokens": jnp.asarray(toks), "targets": jnp.asarray(targets)})
    leaves = _grad_leaves(params)
    loss = model.loss_fn(leaves, {"tokens": torch.from_numpy(toks).long(),
                                  "targets": torch.from_numpy(targets).long()})
    loss.backward()
    checked = []

    def check(leaf, want):
        want = np.asarray(want)
        got = leaf.grad.numpy()
        scale = float(np.max(np.abs(want)))
        assert scale > 0 and np.all(np.isfinite(got))
        assert float(np.max(np.abs(got - want))) <= 1e-4 * scale
        checked.append(leaf.shape)

    tree_map(check, leaves, jgrads)
    assert len(checked) == 14


def test_forward_under_autograd_launches_no_k9(monkeypatch):
    """Above 512 tokens the forward calls the K9 op only where autograd
    does not record: ``make_prefill`` (no grad) calls it once per layer,
    ``loss_fn(...).backward()`` on leaves that require grad never, and
    runs (it raised "flash_attention has no backward" before). The op
    itself still refuses inputs that require grad."""
    _, _, model, params = _models("float32")
    calls = []

    def spy(q, k, v):
        calls.append(torch.is_grad_enabled())
        return flash_attention(q, k, v)

    monkeypatch.setattr(port_attention, "flash_attention", spy)
    toks = torch.from_numpy(_tokens(12, 1, 600, model.cfg.vocab)).long()
    make_prefill(model)(params, {"tokens": toks})
    assert calls == [False] * model.cfg.n_layers
    calls.clear()
    leaves = _grad_leaves(params)
    loss = model.loss_fn(leaves, {"tokens": toks, "targets": toks})
    loss.backward()
    assert calls == []
    assert all(bool(torch.isfinite(leaf.grad).all()) for leaf in
               (leaves["embed"], leaves["layers"][0]["mixer"]["wq"]))
    q = torch.zeros((1, 600, 4, 64), requires_grad=True)
    kv = torch.zeros((1, 600, 2, 64))
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention(q, kv, kv)
