"""Shared pieces of the port's Hutchinson tests against the reference
(``tests/test_torch_hvp_reference*.py``): each family's reduced config
built on both sides in f32 with remat (the train step's model), the
reference's own probes, and the two checks.

* ``check_hz``: the port's ``grad_and_hvp`` (a double backward) against
  the reference's ``jax.jvp`` of ``jax.grad`` given the reference's z of
  (step 0, silo 0): every leaf of the gradient and of Hz within ``REL``
  of its largest |value| of the reference's, as ``test_torch_train.py``'s
  ``_close_per_leaf`` (f32, the two frameworks sum in other orders;
  measured at most 5e-6).
* ``check_step``: one ``make_train_step(..., hvp=True)`` step (2 silos,
  a refresh on the first step, the reference's probes) against the
  reference's jitted step. Block-Top-K keeps every entry (k = block^2 =
  64), so H is the two silos' mean z * Hz and compares entry by entry:
  the loss within 1e-5 relative, H and the params within ``REL`` of
  each leaf's largest |value|.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_lm import as_np, batches, modality_inputs, tokens
from repro.configs import get_config as jax_get_config
from repro.launch.steps import make_optimizer as jax_make_optimizer
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.models import common as jax_common
from repro.models.transformer import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy
from repro_torch.launch.steps import (grad_and_hvp, make_optimizer,
                                      make_train_step)
from repro_torch.models import build_model
from repro_torch.tree import tree_leaves, tree_map

REL = 1e-4
OPT = dict(k_per_block=64, block=8, curvature="hutchinson")


@pytest.fixture(autouse=True)
def no_activation_sharder():
    """The reference's model without a mesh sharder, before and after."""
    jax_common.set_activation_sharder(None, None)
    yield
    jax_common.set_activation_sharder(None, None)


@functools.lru_cache(maxsize=None)
def reduced(arch: str):
    """(JAX model, JAX params, port model, port params) of the reduced
    config in f32 with remat, the port's params the reference's
    ``init_params(PRNGKey(0))``."""
    jmodel = jax_build_model(jax_get_config(arch, smoke=True),
                             use_remat=True)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               device="cpu")
    return jmodel, jparams, build_model(get_config(arch, smoke=True),
                                        use_remat=True), params


def reference_z(jparams, step: int, silo: int, probe_seed: int = 0):
    """The reference train step's Rademacher probe of (step, silo)."""
    key = jax.random.fold_in(jax.random.fold_in(
        jax.random.PRNGKey(probe_seed), step), silo)
    leaves, treedef = jax.tree_util.tree_flatten(jparams)
    keys = jax.random.split(key, len(leaves))
    return treedef.unflatten([
        jax.random.rademacher(k, p.shape, jnp.int8).astype(p.dtype)
        for k, p in zip(keys, leaves)])


def reference_probes(jparams):
    """A probe source for the port that hands it the reference's z."""

    def probes(step, silo, params, lays=None):
        z = reference_z(jparams, step, silo)
        return params_from_numpy(jax.tree.map(np.asarray, z), device="cpu")

    return probes


def close_per_leaf(got_tree, want_tree, rel: float = REL) -> int:
    """Each leaf of ``got_tree`` (the port's) within ``rel`` of its
    largest |value| of ``want_tree`` (the reference's, matched by key);
    the number of leaves checked."""
    checked = []

    def check(g, w):
        w = as_np(w)
        scale = float(np.max(np.abs(w)))
        gap = float(np.max(np.abs(as_np(g) - w)))
        assert scale > 0 and gap <= rel * scale, (gap, scale, w.shape)
        checked.append(1)

    tree_map(check, got_tree, want_tree)
    return len(checked)


def two_batches(cfg, b: int, t: int, seed: int):
    """(reference batch, port batch): tokens from ``seed``, the next
    token as the target, and the family's frames or patches."""
    toks = tokens(seed, b, t, cfg.vocab)
    return batches(toks, np.roll(toks, -1, axis=1),
                   modality_inputs(cfg, b, seed + 1))


def check_hz(arch: str, t: int) -> None:
    """``grad_and_hvp`` of silo 0 at B = 2, T = ``t`` against
    ``jax.jvp(jax.grad(loss_fn))``, with the reference's z."""
    jmodel, jparams, model, params = reduced(arch)
    jb, b = two_batches(model.cfg, 2, t, seed=t)
    z = reference_z(jparams, 0, 0)
    jg, jhz = jax.jvp(lambda p: jax.grad(jmodel.loss_fn)(p, jb),
                      (jparams,), (z,))
    g, hz = grad_and_hvp(model, params, b,
                         reference_probes(jparams)(0, 0, params))
    n = len(tree_leaves(params))
    assert close_per_leaf(g, jg) == n
    assert close_per_leaf(hz, jhz) == n


def check_step(arch: str) -> None:
    """One hvp=True fednl step at B = 4 (2 silos), T = 32 against the
    reference's jitted step."""
    jmodel, jparams, model, params = reduced(arch)
    jb, b = two_batches(model.cfg, 4, 32, seed=0)
    opt = make_optimizer("fednl", 1e-3, **OPT)
    step = make_train_step(model, opt, refresh_every=1, n_silos=2, hvp=True,
                           probes=reference_probes(jparams))
    p, state, m = step(params, opt.init(params), b)
    jopt = jax_make_optimizer("fednl", 1e-3, **OPT)
    jstep = jax.jit(jax_make_train_step(jmodel, jopt, refresh_every=1,
                                        n_silos=2, hvp=True))
    jp, jstate, jm = jstep(jparams, jopt.init(jparams), jb)
    assert m["curv_refreshed"] == float(jm["curv_refreshed"]) == 1.0
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    n = len(tree_leaves(params))
    assert close_per_leaf(state.h, jstate.h) == n
    assert close_per_leaf(p, jp) == n
