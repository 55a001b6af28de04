"""The port's optimizers against ``repro.second_order`` on the same numpy
inputs: ``sgd``, ``adamw`` and the FedNL curvature learner
``FedNLPrecondOptimizer`` (update, refresh, precondition), plus the
qwen2-0.5B parameter tree the port sizes its chip run with.

Tolerance: 1e-6 relative to the largest entry of each tensor (f32
arithmetic; an entry that cancels to near zero, as momentum can, carries
the absolute error of its terms). The reference's payload selection off
the TPU is a sort and the port's the Pallas kernel's bisection: on this
tie-free data both keep the same entries, so the dense H they learn
agrees; the payloads' own bits are held in ``test_torch_kernels.py`` and
``test_torch_block_topk.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)
from repro.second_order import FedNLPrecondOptimizer as JaxFedNLPrecond
from repro.second_order import adamw as jax_adamw
from repro.second_order import sgd as jax_sgd
from repro_torch.configs.qwen2_0_5b import param_shapes
from repro_torch.interop import params_from_numpy, precond_state_from_numpy
from repro_torch.second_order import (
    FedNLPrecondOptimizer,
    Optimizer,
    adamw,
    apply_updates,
    fednl_precond,
    sgd,
)
from repro_torch.tree import tree_leaves, tree_map

SHAPES = {"scalar": (), "bias": (13,), "w": (20, 19), "stacked": (3, 10, 12)}


def _close(got, want, rtol=1e-6):
    """Port tree ``got`` (tensors) against reference tree ``want``."""
    def check(g, w):
        w = np.asarray(w, dtype=np.float64)
        g = g.detach().to(torch.float64).numpy()
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=rtol,
                                   atol=rtol * float(np.max(np.abs(w))))
    tree_map(check, got, want)


def _draw(rng, n_silos=None, dtype=np.float32):
    lead = () if n_silos is None else (n_silos,)
    return {k: rng.standard_normal(lead + s).astype(dtype)
            for k, s in SHAPES.items()}


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _to_np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("make,kw", [
    ("sgd", dict(lr=0.1)),
    ("sgd", dict(lr=0.1, momentum=0.9, weight_decay=0.01)),
    ("adamw", dict(lr=3e-3)),
    ("adamw", dict(lr=3e-3, b2=0.999, weight_decay=0.0)),
])
def test_first_order_optimizers_match_reference(make, kw):
    rng = np.random.default_rng(31)
    params = _draw(rng)
    jax_opt = {"sgd": jax_sgd, "adamw": jax_adamw}[make](**kw)
    opt = {"sgd": sgd, "adamw": adamw}[make](**kw)
    jp, p = _to_jax(params), params_from_numpy(params, device="cpu")
    js, s = jax_opt.init(jp), opt.init(p)
    for _ in range(3):
        g = _draw(rng)
        ju, js = jax_opt.update(_to_jax(g), js, jp)
        u, s = opt.update(params_from_numpy(g, device="cpu"), s, p)
        _close(u, _to_np(ju))
        jp = jax.tree.map(lambda a, b: (a + b).astype(a.dtype), jp, ju)
        p = apply_updates(p, u)
    _close(p, _to_np(jp))
    assert s.step == int(js.step) == 3
    if s.mu is not None:
        _close(s.mu, _to_np(js.mu))
    if s.nu is not None:
        _close(s.nu, _to_np(js.nu))


@pytest.mark.parametrize("n_silos", [None, 3])
@pytest.mark.parametrize("block,k", [(8, 6), (32, 40)])
def test_fednl_precond_matches_reference(n_silos, block, k):
    """Three learn-and-step updates, then one refresh and one
    precondition: H, l, mu and the updates after every call, for a
    tensor of each rank (0-d, 1-d, 2-d, 3-d stacked)."""
    rng = np.random.default_rng(32 + (n_silos or 0) + block)
    kw = dict(lr=1e-2, k_per_block=k, block=block, weight_decay=1e-3)
    jopt, opt = JaxFedNLPrecond(**kw), FedNLPrecondOptimizer(**kw)
    params = _draw(rng)
    jp, p = _to_jax(params), params_from_numpy(params, device="cpu")
    js, s = jopt.init(jp), opt.init(p)

    def observations():
        if n_silos is None:
            return _draw(rng), None
        per_silo = _draw(rng, n_silos)
        grads = {key: v.mean(axis=0) for key, v in per_silo.items()}
        return grads, {key: v * v for key, v in per_silo.items()}

    def compare():
        _close(s.h, _to_np(js.h))
        _close(s.mu, _to_np(js.mu))
        _close(s.l, _to_np(js.l))
        assert s.step == int(js.step)

    with jax.enable_x64(False):
        for _ in range(3):
            g, obs = observations()
            jobs = None if obs is None else _to_jax(obs)
            tobs = None if obs is None else params_from_numpy(obs, "cpu")
            ju, js = jopt.update(_to_jax(g), js, jp, jobs)
            u, s = opt.update(params_from_numpy(g, "cpu"), s, p, tobs)
            _close(u, _to_np(ju))
            compare()
        g, obs = observations()
        obs = obs if obs is not None else {key: v * v for key, v in g.items()}
        js = jopt.refresh(js, _to_jax(obs))
        s = opt.refresh(s, params_from_numpy(obs, "cpu"))
        compare()
        ju, js = jopt.precondition(_to_jax(g), js, jp)
        u, s = opt.precondition(params_from_numpy(g, "cpu"), s, p)
        _close(u, _to_np(ju))
        compare()
    assert all(h.dtype == torch.float32 for h in tree_leaves(s.h))
    assert all(v.dtype == torch.float32 for v in tree_leaves(u))


def test_fednl_precond_continues_from_a_reference_state():
    """A reference state crosses over through ``precond_state_from_numpy``
    and the next step agrees."""
    rng = np.random.default_rng(33)
    kw = dict(lr=1e-2, k_per_block=6, block=8)
    jopt, opt = JaxFedNLPrecond(**kw), FedNLPrecondOptimizer(**kw)
    params = _draw(rng)
    jp = _to_jax(params)
    _, js = jopt.update(_to_jax(_draw(rng)), jopt.init(jp), jp)
    state = precond_state_from_numpy(js.step, _to_np(js.h), _to_np(js.mu),
                                     _to_np(js.l), device="cpu")
    g = _draw(rng)
    ju, js = jopt.update(_to_jax(g), js, jp)
    u, state = opt.update(params_from_numpy(g, "cpu"), state,
                          params_from_numpy(params, "cpu"))
    _close(u, _to_np(ju))
    _close(state.h, _to_np(js.h))
    assert precond_state_from_numpy(0, {}, {}, (), device="cpu").l is None


def test_observe_bf16_fisher_and_hutchinson():
    """Fisher squares bf16 gradients in f32; Hutchinson multiplies the
    probe by Hz in f32 and refuses to run without the probe."""
    rng = np.random.default_rng(34)
    g = {key: v.astype(jnp.bfloat16) for key, v in _draw(rng).items()}
    z, hz = _draw(rng), _draw(rng)
    want = _to_np(JaxFedNLPrecond().observe(_to_jax(g)))
    got = FedNLPrecondOptimizer().observe(params_from_numpy(g, "cpu"))
    tree_map(lambda t, w: np.testing.assert_array_equal(t.numpy(), w),
             got, want)
    jhut = JaxFedNLPrecond(curvature="hutchinson")
    hut = FedNLPrecondOptimizer(curvature="hutchinson")
    want = _to_np(jhut.observe(None, hvp=(_to_jax(z), _to_jax(hz))))
    got = hut.observe(None, hvp=(params_from_numpy(z, "cpu"),
                                 params_from_numpy(hz, "cpu")))
    tree_map(lambda t, w: np.testing.assert_array_equal(t.numpy(), w),
             got, want)
    with pytest.raises(ValueError, match="hvp"):
        hut.observe(params_from_numpy(g, "cpu"))


def test_fednl_precond_adapter_binds_the_hooks():
    opt = fednl_precond(lr=0.5, k_per_block=4, block=8)
    assert isinstance(opt, Optimizer)
    assert opt.refresh is not None and opt.precondition is not None
    assert opt.observe is not None and opt.uplink_bits is not None
    tree = _draw(np.random.default_rng(35))
    with jax.enable_x64(True):
        want = JaxFedNLPrecond(k_per_block=4, block=8).uplink_bits(
            tree, n_silos=3)
    assert opt.uplink_bits(tree, n_silos=3) == want > 0
    p = params_from_numpy(tree, "cpu")
    state = opt.init(p)
    u, state = opt.update(p, state, p)
    assert state.step == 1
    assert all(a.shape == b.shape
               for a, b in zip(tree_leaves(u), tree_leaves(p)))


@pytest.mark.parametrize("block,k", [(8, 6), (8, 100)])
def test_fednl_precond_compressor_matches_reference(block, k):
    """The optimizer's uplink codec: each silo's payload of every
    tensor's 2-D view, bit for bit as the JAX optimizer's compressor
    (k clamped to the tile), its server mean and its Def 3.3 spec."""
    from repro_torch.second_order.fednl_precond import _shape2d

    rng = np.random.default_rng(36 + k)
    jcomp = JaxFedNLPrecond(k_per_block=k, block=block).compressor
    comp = FedNLPrecondOptimizer(k_per_block=k, block=block).compressor
    assert comp.k_per_block == jcomp.k_per_block == min(k, block * block)
    for obs in _draw(rng, n_silos=3).values():
        shape2 = _shape2d(obs.shape[1:])
        x = obs.reshape((3,) + shape2)
        got = comp.compress(torch.from_numpy(x))
        with jax.enable_x64(False):
            want = [jcomp.compress(jnp.asarray(xi)) for xi in x]
            want_mean = np.asarray(jcomp.aggregate(
                jax.tree.map(lambda *p: jnp.stack(p), *want), shape2))
        np.testing.assert_array_equal(
            got.values.numpy(), np.stack([np.asarray(p.values) for p in want]))
        np.testing.assert_array_equal(
            got.indices.numpy(), np.stack([np.asarray(p.indices) for p in want]))
        mean = comp.aggregate(got, shape2)
        np.testing.assert_allclose(mean.numpy(), want_mean, rtol=1e-6,
                                   atol=1e-6 * float(np.max(np.abs(want_mean))))
        assert comp.spec(shape2) == jcomp.spec(shape2)


def test_qwen2_param_shapes_match_reference_init():
    """The port's qwen2-0.5B tree has the paths, shapes and dtype of the
    reference model's ``init_params`` (traced, no weights made)."""
    from repro.configs import get_config as jax_get_config
    from repro.models.transformer import build_model

    model = build_model(jax_get_config("qwen2-0.5b"))
    want = jax.eval_shape(model.init_params, jax.random.PRNGKey(0))
    got = param_shapes()
    paths = []

    def check(spec, ref):
        assert tuple(spec.shape) == tuple(ref.shape)
        assert spec.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
        paths.append(spec.shape)

    tree_map(check, got, want)
    assert len(paths) == len(jax.tree.leaves(want)) == 14
    assert sum(int(np.prod(s)) for s in paths) == 494_032_768
