"""The port's train step (``launch/steps.make_train_step`` with
``make_optimizer``), its model's remat, the token pipeline, checkpoints,
the input shapes and the train driver against the JAX reference.

The model is the reference's ``_tiny`` qwen2 of ``tests/test_train_step.py``
(1 layer, d 64, f32), its weights carried across by ``interop`` and its
batches made by the reference as numpy. The reference's step is jitted.
Tolerances: the port's curvature H, Hz and params within 1e-4 of each
leaf's largest |value| of the reference's (f32, two summation orders);
the port against itself (remat on and off, a first-order step with and
without the curvature arguments) bit for bit; microbatches 4 against 1
at the reference's own tolerances.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dist import one_rank_group
from _torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)
from repro import checkpoint as jax_checkpoint
from repro.configs import get_config as jax_get_config
from repro.data.tokens import TokenPipeline as JaxTokenPipeline
from repro.launch import shapes as jax_shapes
from repro.launch.steps import make_optimizer as jax_make_optimizer
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.models import build_model as jax_build_model
from repro.models import common as jax_common
from repro_torch import checkpoint
from repro_torch.configs import get_config
from repro_torch.data.tokens import TokenPipeline
from repro_torch.interop import params_from_numpy
from repro_torch.launch import shapes
from repro_torch.launch.steps import (
    grad_and_hvp,
    make_optimizer,
    make_train_step,
)
from repro_torch.models import build_model
from repro_torch.tree import tree_leaves, tree_map

QWEN = "qwen2-0.5b"
TINY = dict(n_layers=1, d_model=64, d_ff=128, vocab=128)


@pytest.fixture(autouse=True)
def no_activation_sharder():
    """Run the JAX model without a mesh sharder and put back whatever
    was installed: a test elsewhere on the same worker may leave one."""
    saved = (jax_common._ACT_CONSTRAINT, jax_common._LAYER_PARAM_CONSTRAINT)
    jax_common.set_activation_sharder(None, None)
    yield
    jax_common.set_activation_sharder(*saved)


@functools.lru_cache(maxsize=None)
def _tiny_ref():
    cfg = jax_get_config(QWEN).reduced(**TINY)
    model = jax_build_model(cfg, use_remat=True)
    return cfg, model, model.init_params(jax.random.PRNGKey(0))


def _tiny():
    """(JAX model, JAX params, port model, port params): the reference's
    ``_tiny`` and the port's copy of it."""
    _, jmodel, jparams = _tiny_ref()
    model = build_model(get_config(QWEN).reduced(**TINY), use_remat=True)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               device="cpu")
    return jmodel, jparams, model, params


def _batch(b=4, t=32, seed=0):
    """The reference's ``_batch``: (jax batch, port batch)."""
    toks = jax.random.randint(jax.random.PRNGKey(seed), (b, t), 0,
                              TINY["vocab"])
    jb = {"tokens": toks, "targets": jnp.roll(toks, -1, axis=1)}
    return jb, {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _jax_leaves_in_port_order(jtree, port_tree) -> list:
    """The reference tree's leaves in the port's leaf order (the port
    walks dicts in insertion order, JAX in sorted key order)."""
    nested = jax.tree.map(np.asarray, jtree)
    return tree_leaves(tree_map(lambda _, x: x, port_tree, nested))


def _close_per_leaf(got_tree, want_jax_tree, rel=1e-4):
    got = [_np(x) for x in tree_leaves(got_tree)]
    want = [_np(x) for x in _jax_leaves_in_port_order(want_jax_tree,
                                                      got_tree)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        scale = float(np.max(np.abs(w)))
        gap = float(np.max(np.abs(g - w)))
        assert gap <= rel * max(scale, 1e-30), (gap, scale, w.shape)


def _reference_z(params, step: int, silo: int, probe_seed: int = 0):
    """The reference step's Rademacher probe of (step, silo)."""
    key = jax.random.fold_in(jax.random.fold_in(
        jax.random.PRNGKey(probe_seed), step), silo)
    leaves, treedef = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(key, len(leaves))
    return treedef.unflatten([
        jax.random.rademacher(k, p.shape, jnp.int8).astype(p.dtype)
        for k, p in zip(keys, leaves)])


def _reference_probes(jparams):
    """A probe source for the port that hands it the reference's z."""

    def probes(step, silo, params):
        z = _reference_z(jparams, step, silo)
        return params_from_numpy(jax.tree.map(np.asarray, z), device="cpu")

    return probes


# -- the curvature phase ---------------------------------------------------------


def test_fednl_observations_reach_refresh():
    """Exact compression (k = block^2), alpha 1, from H = 0: one step
    leaves H = the two silos' mean g^2 (the reference's test), and equal
    to the reference's jitted step's H."""
    jmodel, jparams, model, params = _tiny()
    jb, b = _batch()
    opt = make_optimizer("fednl", 1e-2, k_per_block=64, block=8)
    step = make_train_step(model, opt, refresh_every=1, n_silos=2)
    _, state, metrics = step(params, opt.init(params), b)
    assert metrics["curv_refreshed"] == 1.0

    def g_sq(half):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        it = iter(leaves)
        tree = tree_map(lambda _: next(it), params)
        loss = model.loss_fn(tree, {k: v[2 * half:2 * half + 2]
                                    for k, v in b.items()})
        return [g.float() ** 2 for g in torch.autograd.grad(loss, leaves)]

    want = [(a + c) / 2 for a, c in zip(g_sq(0), g_sq(1))]
    for h, w in zip(tree_leaves(state.h), want):
        np.testing.assert_allclose(h.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-7)
    assert all(float(x) > 0 for x in tree_leaves(state.l))

    jopt = jax_make_optimizer("fednl", 1e-2, k_per_block=64, block=8)
    jstep = jax.jit(jax_make_train_step(jmodel, jopt, refresh_every=1,
                                        n_silos=2))
    _, jstate, _ = jstep(jparams, jopt.init(jparams), jb)
    _close_per_leaf(state.h, jstate.h)


def test_refresh_interval_gates_curvature():
    """refresh_every=2: steps 0 and 2 refresh, step 1 leaves H bit for
    bit while it still preconditions; flags, H and params follow the
    reference's jitted step."""
    jmodel, jparams, model, params = _tiny()
    opt = make_optimizer("fednl", 1e-2, k_per_block=64, block=8)
    step = make_train_step(model, opt, refresh_every=2, n_silos=2)
    jopt = jax_make_optimizer("fednl", 1e-2, k_per_block=64, block=8)
    jstep = jax.jit(jax_make_train_step(jmodel, jopt, refresh_every=2,
                                        n_silos=2))
    state, jstate = opt.init(params), jopt.init(jparams)
    flags, jflags, hs = [], [], []
    p, jp = params, jparams
    for i in range(3):
        jb, b = _batch(seed=i)
        p, state, m = step(p, state, b)
        jp, jstate, jm = jstep(jp, jstate, jb)
        flags.append(m["curv_refreshed"])
        jflags.append(float(jm["curv_refreshed"]))
        hs.append([h.clone() for h in tree_leaves(state.h)])
        assert np.isfinite(float(m["loss"]))
        _close_per_leaf(state.h, jstate.h)
    assert flags == jflags == [1.0, 0.0, 1.0]
    assert all(torch.equal(a, c) for a, c in zip(hs[0], hs[1]))
    assert float(torch.max(torch.abs(hs[2][0] - hs[1][0]))) > 0
    _close_per_leaf(p, jp)


def test_microbatch_accumulation_equivalence():
    """microbatches=4 reproduces the one-batch step (the reference's
    tolerances), and follows the reference's microbatched step."""
    jmodel, jparams, model, params = _tiny()
    jb, b = _batch(b=4)
    opt = make_optimizer("adamw", 1e-3)
    p1, _, m1 = make_train_step(model, opt, microbatches=1)(
        params, opt.init(params), b)
    p4, _, m4 = make_train_step(model, opt, microbatches=4)(
        params, opt.init(params), b)
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(m1["grad_norm"]),
                               float(m4["grad_norm"]), rtol=1e-4)
    for a, c in zip(tree_leaves(p1), tree_leaves(p4)):
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=1e-4,
                                   atol=1e-6)
    jopt = jax_make_optimizer("adamw", 1e-3)
    jp4, _, jm4 = jax.jit(jax_make_train_step(jmodel, jopt, microbatches=4))(
        jparams, jopt.init(jparams), jb)
    np.testing.assert_allclose(float(m4["loss"]), float(jm4["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m4["grad_norm"]),
                               float(jm4["grad_norm"]), rtol=1e-4)
    _close_per_leaf(p4, jp4)


def test_first_order_path_unchanged():
    """A first-order step built with the curvature arguments gives the
    plain step's params bit for bit and never reports a refresh."""
    _, _, model, params = _tiny()
    _, b = _batch()
    opt = make_optimizer("adamw", 1e-3)
    p_a, _, m_a = make_train_step(model, opt)(params, opt.init(params), b)
    p_b, _, m_b = make_train_step(model, opt, refresh_every=8, n_silos=2)(
        params, opt.init(params), b)
    assert m_a["curv_refreshed"] == m_b["curv_refreshed"] == 0.0
    for a, c in zip(tree_leaves(p_a), tree_leaves(p_b)):
        assert torch.equal(a, c)


@pytest.mark.parametrize("t", [32, 600])
def test_hutchinson_probe_matches_reference(t):
    """With the reference's z: silo 0's Hz (double backward) equals the
    reference's ``jax.jvp`` of ``jax.grad``, and one hvp=True step's H
    the reference's jitted step's. T=600 takes ``_sdpa_chunked`` (its
    checkpointed query chunks) under the double backward."""
    jmodel, jparams, model, params = _tiny()
    jb, b = _batch(b=2, t=t)
    half = {k: v[:1] for k, v in b.items()}
    jhalf = {k: v[:1] for k, v in jb.items()}
    z = _reference_z(jparams, 0, 0)
    _, jhz = jax.jvp(lambda p: jax.grad(jmodel.loss_fn)(p, jhalf),
                     (jparams,), (z,))
    _, hz = grad_and_hvp(model, params, half,
                         _reference_probes(jparams)(0, 0, params))
    _close_per_leaf(hz, jhz)

    opt = make_optimizer("fednl", 1e-3, k_per_block=64, block=8,
                         curvature="hutchinson")
    step = make_train_step(model, opt, refresh_every=1, n_silos=2, hvp=True,
                           probes=_reference_probes(jparams))
    _, state, m = step(params, opt.init(params), b)
    assert m["curv_refreshed"] == 1.0 and np.isfinite(float(m["loss"]))
    jopt = jax_make_optimizer("fednl", 1e-3, k_per_block=64, block=8,
                              curvature="hutchinson")
    jstep = jax.jit(jax_make_train_step(jmodel, jopt, refresh_every=1,
                                        n_silos=2, hvp=True))
    _, jstate, _ = jstep(jparams, jopt.init(jparams), jb)
    _close_per_leaf(state.h, jstate.h)


def test_default_probes_are_rademacher_per_step_and_silo():
    from repro_torch.launch.steps import RademacherProbes

    _, _, _, params = _tiny()
    probes = RademacherProbes(3)
    a = tree_leaves(probes(1, 0, params))
    assert all(torch.equal(x, y)
               for x, y in zip(a, tree_leaves(probes(1, 0, params))))
    for other in (probes(2, 0, params), probes(1, 1, params),
                  RademacherProbes(4)(1, 0, params)):
        assert not torch.equal(a[0], tree_leaves(other)[0])
    for x, p in zip(a, tree_leaves(params)):
        assert x.dtype == p.dtype and x.shape == p.shape
        assert set(torch.unique(x).tolist()) == {-1.0, 1.0}


def test_make_optimizer_names():
    for name in ("adamw", "sgd", "fednl"):
        assert make_optimizer(name, 1e-3).init is not None
    assert make_optimizer("fednl", 1e-3).refresh is not None
    assert make_optimizer("adamw", 1e-3).refresh is None
    with pytest.raises(ValueError):
        make_optimizer("lion", 1e-3)


# -- remat ---------------------------------------------------------------------------


@pytest.mark.parametrize("t", [32, 600])
def test_remat_gives_the_same_loss_and_grads(t):
    cfg = get_config(QWEN, smoke=True)
    params = build_model(cfg).init_params(torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (2, t),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks, "targets": toks.roll(-1, dims=1)}
    out = []
    for remat in (True, False):
        leaves = tree_map(lambda p: p.detach().clone().requires_grad_(True),
                          params)
        loss = build_model(cfg, use_remat=remat).loss_fn(leaves, batch)
        loss.backward()
        out.append((loss.detach(), [p.grad for p in tree_leaves(leaves)]))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, c) for a, c in zip(out[0][1], out[1][1]))


# -- tokens, checkpoints, shapes ---------------------------------------------------------


def test_token_pipeline_is_deterministic_with_motifs():
    pipe = TokenPipeline(vocab_size=500, seq_len=64, global_batch=6, seed=2)
    a, again = pipe.batch(3, device="cpu"), pipe.batch(3, device="cpu")
    assert all(torch.equal(a[k], again[k]) for k in a)
    assert not torch.equal(a["tokens"], pipe.batch(4, device="cpu")["tokens"])
    other = dataclasses.replace(pipe, seed=3).batch(3, device="cpu")
    assert not torch.equal(a["tokens"], other["tokens"])
    want = JaxTokenPipeline(vocab_size=500, seq_len=64, global_batch=6).batch(0)
    for k in ("tokens", "targets"):
        assert tuple(a[k].shape) == want[k].shape
        assert a[k].dtype == torch.int32 and str(want[k].dtype) == "int32"
    toks = a["tokens"]
    assert int(toks.min()) >= 0 and int(toks.max()) < 500
    assert torch.equal(a["targets"], toks.roll(-1, dims=-1))
    motifs = pipe.motifs().tolist()
    for row in toks.tolist():
        assert any(any(row[o:o + 16] == m for m in motifs)
                   for o in range(64 - 16))
    # Zipfian: the smallest ids are the most frequent
    big = pipe.batch(0, device="cpu")["tokens"].reshape(-1)
    assert int((big < 10).sum()) > int(((big >= 250) & (big < 260)).sum())


@pytest.mark.parametrize("direction", ["port_to_reference",
                                       "reference_to_port"])
def test_checkpoints_restore_across_packages(tmp_path, direction):
    jcfg = jax_get_config(QWEN).reduced(**TINY)
    jcfg = dataclasses.replace(jcfg, dtype="bfloat16")
    jparams = jax_build_model(jcfg).init_params(jax.random.PRNGKey(1))
    jtree = {"params": jparams, "meta": {"scale": jnp.ones((3,), jnp.float32)}}
    tree = {"params": params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        device="cpu"),
            "meta": {"scale": torch.ones(3)}}
    path = str(tmp_path / "ckpt")
    if direction == "port_to_reference":
        checkpoint.save(path, tree, step=7)
        got, step = jax_checkpoint.restore(path, jtree)
        want = tree
        got_leaves = _jax_leaves_in_port_order(got, want)
    else:
        jax_checkpoint.save(path, jtree, step=7)
        got, step = checkpoint.restore(path, tree)
        want = tree
        got_leaves = tree_leaves(got)
        assert all(x.dtype == y.dtype
                   for x, y in zip(tree_leaves(got), tree_leaves(tree)))
    assert step == 7
    for g, w in zip(got_leaves, tree_leaves(want)):
        assert np.array_equal(_np(g), _np(w))


def test_checkpoint_refuses_another_structure(tmp_path):
    checkpoint.save(str(tmp_path), {"a": torch.ones(2)})
    with pytest.raises(ValueError, match="leaves"):
        checkpoint.restore(str(tmp_path), {"a": torch.ones(2),
                                           "b": torch.ones(1)})


def test_shapes_match_reference():
    assert {k: dataclasses.astuple(v) for k, v in shapes.SHAPES.items()} == {
        k: dataclasses.astuple(v) for k, v in jax_shapes.SHAPES.items()}
    cfg, jcfg = get_config(QWEN), jax_get_config(QWEN)
    jmodel = jax_build_model(jcfg)
    for name, shape in shapes.SHAPES.items():
        jshape = jax_shapes.SHAPES[name]
        assert shapes.skip_reason(cfg, shape) == jax_shapes.skip_reason(
            jcfg, jshape)
        if shape.kind == "decode":
            if shape.name != "decode_32k":
                continue
            got = shapes.decode_input_specs(cfg, shape, build_model(cfg))
            want = jax_shapes.decode_input_specs(jcfg, jshape, jmodel)
            assert got["token"].device.type == "meta"
            assert ([tuple(x.shape) for x in tree_leaves(got["cache"])]
                    == [x.shape for x in jax.tree.leaves(want["cache"])])
            assert tuple(got["token"].shape) == want["token"].shape
            continue
        got = shapes.token_batch_specs(cfg, shape)
        want = jax_shapes.token_batch_specs(jcfg, jshape)
        assert {k: tuple(v.shape) for k, v in got.items()} == {
            k: v.shape for k, v in want.items()}


# -- the train driver ---------------------------------------------------------------


@pytest.mark.slow
@pytest.mark.parametrize("optimizer,lr", [("adamw", "1e-3"),
                                          ("fednl", "2e-3")])
def test_train_driver_learns(optimizer, lr, capsys):
    """The reference's ``test_train_driver_learns`` and its fednl twin,
    through the CLI on the CPU: 30 steps at the smoke config."""
    from repro_torch.launch.train import main

    with one_rank_group():
        hist = main(["--steps", "30", "--batch", "4", "--seq", "64", "--lr",
                     lr, "--optimizer", optimizer, "--device", "cpu"])
    assert hist[-1] < hist[0] - 0.5, hist[:3] + hist[-3:]
    out = capsys.readouterr().out
    assert ("curvature uplink" in out) == (optimizer == "fednl")
