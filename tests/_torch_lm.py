"""Shared pieces of the port's language-model parity tests: a reduced
architecture built on both sides with the reference's own
``init_params(PRNGKey(0))`` weights carried across as numpy arrays,
token draws, closeness in f32 and bf16, and the reference's decode loop.

bf16 tolerance: the two frameworks round bf16 at other places (XLA:CPU
computes a chain of bf16 elementwise ops in f32 and rounds once, PyTorch
rounds after each op), so logits drift by a few bf16 steps; they must
agree within 4 steps of the largest value, 4 * 2^-7 * max |want|, as in
``test_torch_models.py``.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.common as jax_common
from repro.configs import get_config as jax_get_config
from repro.launch.steps import make_serve_step as jax_make_serve_step
from repro.models.transformer import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy
from repro_torch.models import build_model
from repro_torch.tree import tree_map

DTYPES = ["float32", "bfloat16"]
BF16_STEPS = 4 * 2.0 ** -7


@pytest.fixture
def no_activation_sharder():
    """Run the JAX model without a mesh sharder, and leave none: a test
    elsewhere on the same worker may leave one (the reference's
    ``launch.train.train`` called in process does), and the reference's
    tests that run after expect none."""
    jax_common.set_activation_sharder(None, None)
    yield
    jax_common.set_activation_sharder(None, None)


@functools.lru_cache(maxsize=None)
def models(arch: str, dtype: str):
    """(JAX model, JAX params, port model, port params) of ``arch``'s
    reduced config in ``dtype``, the port's params copied from the
    reference's."""
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True), dtype=dtype)
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype)
    jmodel = jax_build_model(jcfg, use_remat=False)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return jmodel, jparams, build_model(cfg), params


def as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def close(got, want, dtype: str, tol: float = 1e-4):
    """f32 to ``tol`` (relative and absolute); bf16 within BF16_STEPS of
    the largest |want|."""
    got, want = as_np(got), as_np(want)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    else:
        gap = float(np.max(np.abs(got - want)))
        assert gap <= BF16_STEPS * float(np.max(np.abs(want))), gap


def tokens(seed: int, b: int, t: int, vocab: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (b, t)).astype(
        np.int32)


def modality_inputs(cfg, b: int, seed: int) -> dict:
    """The stubbed modality inputs of ``cfg``'s family as f32 numpy
    arrays, N(0, 1) * 0.02 from ``seed``: a VLM's ``patches``, an
    encoder-decoder's ``frames``; none for the other families."""
    rng = np.random.default_rng(seed)
    shapes = {"vlm": ("patches", cfg.vision_tokens),
              "encdec": ("frames", cfg.enc_seq)}
    if cfg.family not in shapes:
        return {}
    name, n = shapes[cfg.family]
    return {name: (0.02 * rng.standard_normal((b, n, cfg.d_model))).astype(
        np.float32)}


def batches(toks: np.ndarray, targets: np.ndarray, extra: dict) -> tuple:
    """(reference batch, port batch) of the same tokens, targets and
    modality inputs."""
    jb = {"tokens": jnp.asarray(toks), "targets": jnp.asarray(targets),
          **{k: jnp.asarray(v) for k, v in extra.items()}}
    pb = {"tokens": torch.from_numpy(toks).long(),
          "targets": torch.from_numpy(targets).long(),
          **{k: torch.from_numpy(v) for k, v in extra.items()}}
    return jb, pb


def jax_decode(jmodel, jparams, toks: np.ndarray, max_len: int,
               enc=None) -> list:
    """Logits (B, V) of the reference's serve step, token by token;
    ``enc`` (numpy) is an encoder-decoder's memory in the cache."""
    serve = jax.jit(jax_make_serve_step(jmodel))
    cache = jmodel.init_cache(toks.shape[0], max_len)
    if enc is not None:
        cache["enc"] = jnp.asarray(enc).astype(cache["enc"].dtype)
    out = []
    for pos in range(toks.shape[1]):
        lg, cache = serve(jparams, cache, jnp.asarray(toks[:, pos:pos + 1]),
                          jnp.asarray(pos, jnp.int32))
        out.append(as_np(lg[:, 0]))
    return out


def grad_leaves(params) -> dict:
    """Copies of ``params`` that require grad (the cached tree is shared
    by other tests and stays as it is)."""
    return tree_map(lambda a: a.detach().clone().requires_grad_(True), params)


def check_grads_against_reference(jmodel, jparams, model, params,
                                  toks: np.ndarray, extra=None) -> int:
    """``loss_fn(...).backward()`` of the port against ``jax.grad`` of the
    reference's on the same tokens (targets the tokens reversed) and
    modality inputs ``extra``: each leaf within 1e-4 of its largest
    |grad| (f32; the two frameworks sum in other orders). Returns the
    number of leaves checked."""
    jb, pb = batches(toks, toks[:, ::-1].copy(), extra or {})
    jgrads = jax.grad(jmodel.loss_fn)(jparams, jb)
    leaves = grad_leaves(params)
    loss = model.loss_fn(leaves, pb)
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
    return len(checked)


def check_param_shapes_at_full_size(arch: str, param_shapes) -> int:
    """``param_shapes()`` of ``arch`` against ``jax.eval_shape`` of the
    reference's ``init_params`` at the published size: the same paths,
    shapes and dtype. Returns the number of leaves."""
    jcfg = jax_get_config(arch)
    want = jax.eval_shape(jax_build_model(jcfg).init_params,
                          jax.random.PRNGKey(0))
    got = param_shapes()
    n = []

    def check(spec, ref):
        assert tuple(spec.shape) == tuple(ref.shape)
        assert str(spec.dtype).removeprefix("torch.") == str(ref.dtype)
        n.append(1)

    tree_map(check, got, want)
    assert len(n) == len(jax.tree.leaves(want))
    return len(n)
