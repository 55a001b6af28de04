"""Training the port's hybrid and ssm families (jamba-1.5-large-398b,
xlstm-350m) against the JAX package, on the CPU.

Fault C3 (closed): ``mamba._ssm_scan`` wrote each Hillis-Steele step
through ``out=`` and folded the carried state into a chunk's first
increment in place, which autograd cannot differentiate, so a reduced
jamba's ``loss_fn(...).backward()`` raised. Under autograd the scan is
now built out of place, each chunk under ``checkpoint``; without a
gradient it runs as before. Held here: ``gradcheck`` in f64 at T <= 256
(one scan) and above (chunks with padding), the no-grad output equal bit
for bit to the grad path's, the scan's gradient against ``jax.grad`` of
the reference's, and the reduced models' loss gradients against the
reference's.

Then the train step: ``make_train_step`` with fednl (exact Block-Top-K,
k = block^2 = 64, 2 silos, a refresh every 2 steps) on reduced jamba and
xlstm in f32 against the reference's jitted step over 3 steps: loss to
rtol 1e-5, ``curv_refreshed`` equal, H and the parameters within 1e-4 of
each leaf's largest |value| (the port's whole-model tolerance), and the
Mamba, mLSTM and sLSTM leaves with a nonzero curvature. And the train
driver on the CPU against the reference's own criterion
(``tests/test_models_smoke.py:82``, which fails on jax 0.9.0 with a
``ShardingTypeError``): 5 fednl steps at batch 4, seq 32, a refresh
every 2 steps and k = 256, every loss finite and the last below the
first. The reference's train driver is not imported: it installs a
process-wide activation sharder.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_dist import one_rank_group
from _torch_lm import (  # noqa: F401 (fixture)
    as_np,
    check_grads_against_reference,
    no_activation_sharder,
    tokens,
)
from _torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

from repro.configs import get_config as jax_get_config
from repro.launch.steps import make_optimizer as jax_make_optimizer
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.models import mamba as jax_mamba
from repro.models.transformer import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy
from repro_torch.launch.steps import make_optimizer, make_train_step
from repro_torch.models import build_model, mamba
from repro_torch.tree import tree_leaves, tree_map

pytestmark = pytest.mark.usefixtures("no_activation_sharder")

JAMBA, XLSTM = "jamba-1.5-large-398b", "xlstm-350m"
ARCHS = [JAMBA, XLSTM]


# -- C3: the Mamba scan under autograd ----------------------------------------


def _scan_inputs(b: int, t: int, di: int, s: int, seed: int,
                 dtype=np.float64):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((b, t, di))
    dt = 0.1 * rng.random((b, t, di)) + 1e-3
    bb = rng.standard_normal((b, t, s))
    cc = rng.standard_normal((b, t, s))
    a = -np.tile(np.arange(1, s + 1, dtype=np.float64)[None], (di, 1))
    return tuple(x.astype(dtype) for x in (u, dt, bb, cc, a))


# (T, chunk, fast): one scan; chunks of 8 with and without padding; the
# default chunk of 256 with padding (gradcheck's fast mode there: 1,204
# inputs)
GRADCHECK = [(5, 256, False), (20, 8, False), (24, 8, False),
             (300, 256, True)]


@pytest.mark.parametrize("t,chunk,fast", GRADCHECK)
def test_ssm_scan_passes_gradcheck_in_f64(t, chunk, fast):
    args = [torch.from_numpy(x).requires_grad_(True)
            for x in _scan_inputs(1, t, 2, 2, seed=t)]
    assert torch.autograd.gradcheck(
        lambda *a: mamba._ssm_scan(*a, chunk=chunk), args,
        fast_mode=fast)


@pytest.mark.parametrize("t,chunk", [(40, 256), (20, 8), (300, 256)])
def test_ssm_scan_no_grad_equals_the_grad_path(t, chunk):
    """The serving path (no gradient) and the training path give the same
    bits, in f32 at jamba's reduced widths."""
    args = [torch.from_numpy(x) for x in _scan_inputs(
        2, t, 24, 16, seed=t, dtype=np.float32)]
    with torch.no_grad():
        want = mamba._ssm_scan(*args, chunk=chunk)
    got = mamba._ssm_scan(*[x.clone().requires_grad_(True) for x in args],
                          chunk=chunk)
    assert got.requires_grad and torch.equal(got.detach(), want)
    decay = torch.rand((2, t, 3, 2), generator=torch.Generator().manual_seed(1))
    inc = torch.randn((2, t, 3, 2), generator=torch.Generator().manual_seed(2))
    want = mamba._scan(decay, inc.clone())
    assert torch.equal(mamba._scan(decay, inc.clone().requires_grad_(True))
                       .detach(), want)


@pytest.mark.parametrize("t,chunk", [(40, 256), (20, 8), (300, 256)])
def test_ssm_scan_gradient_matches_reference(t, chunk):
    """d sum(y * w) / d (u, dt, B, C, A) against ``jax.grad`` of the
    reference's ``_ssm_scan``, f32, each within 1e-5 of its largest
    |value| (both scans are log-depth over other trees)."""
    args = _scan_inputs(2, t, 24, 16, seed=t + 1, dtype=np.float32)
    w = np.random.default_rng(t).standard_normal((2, t, 24)).astype(
        np.float32)
    want = jax.grad(lambda *a: jnp.sum(jax_mamba._ssm_scan(*a, chunk=chunk)
                                       * w), argnums=(0, 1, 2, 3, 4))(
        *map(jnp.asarray, args))
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in args]
    (mamba._ssm_scan(*leaves, chunk=chunk) * torch.from_numpy(w)).sum(
    ).backward()
    for leaf, ref in zip(leaves, want):
        ref = as_np(ref)
        gap = float(np.max(np.abs(leaf.grad.numpy() - ref)))
        assert gap <= 1e-5 * float(np.max(np.abs(ref))), (leaf.shape, gap)


@functools.lru_cache(maxsize=None)
def _reduced(arch: str, remat: bool = True):
    """(JAX model, JAX params, port model, port params) of the reduced
    config in f32, the port's params copied from the reference's
    ``init_params(PRNGKey(0))``."""
    jmodel = jax_build_model(jax_get_config(arch, smoke=True),
                             use_remat=remat)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               device="cpu")
    return jmodel, jparams, build_model(get_config(arch, smoke=True),
                                        use_remat=remat), params


@pytest.mark.parametrize("t", [64, 300])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_gradient_matches_reference(arch, t):
    """``loss_fn(...).backward()`` of reduced jamba (fault C3's case) and
    xlstm against ``jax.grad``, every leaf within 1e-4 of its largest
    |grad|; T = 300 takes the Mamba scan over two chunks of 256 with
    padding."""
    jmodel, jparams, model, params = _reduced(arch)
    toks = tokens(t, 2, t, model.cfg.vocab)
    n = check_grads_against_reference(jmodel, jparams, model, params, toks)
    assert n == len(tree_leaves(params))


# -- the fednl train step against the reference's jitted step -----------------


def _batch(seed: int, vocab: int, b: int = 4, t: int = 32):
    toks = jax.random.randint(jax.random.PRNGKey(seed), (b, t), 0, vocab)
    jb = {"tokens": toks, "targets": jnp.roll(toks, -1, axis=1)}
    return jb, {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}


def _close_per_leaf(got_tree, want_tree, rel=1e-4) -> int:
    checked = []

    def check(g, w):
        w = as_np(w)
        gap = float(np.max(np.abs(as_np(g) - w)))
        assert gap <= rel * max(float(np.max(np.abs(w))), 1e-30), w.shape
        checked.append(1)

    tree_map(check, got_tree, want_tree)
    return len(checked)


# the recurrent mixers' leaves that must reach the refresh
RECURRENT_LEAVES = {JAMBA: ("a_log", "wdt", "conv", "wbc", "win", "wout"),
                    XLSTM: ("wq", "wk", "wv", "wif", "wo_gate", "wout")}


@pytest.mark.parametrize("arch", ARCHS)
def test_fednl_train_step_matches_reference(arch):
    """3 fednl steps on the reduced model (f32, 2 silos, a refresh every
    2 steps) against the reference's jitted ``make_train_step``."""
    jmodel, jparams, model, params = _reduced(arch)
    kw = dict(k_per_block=64, block=8)
    opt = make_optimizer("fednl", 1e-2, **kw)
    step = make_train_step(model, opt, refresh_every=2, n_silos=2)
    jopt = jax_make_optimizer("fednl", 1e-2, **kw)
    jstep = jax.jit(jax_make_train_step(jmodel, jopt, refresh_every=2,
                                        n_silos=2))
    state, jstate = opt.init(params), jopt.init(jparams)
    p, jp = params, jparams
    for i in range(3):
        jb, b = _batch(i, model.cfg.vocab)
        p, state, m = step(p, state, b)
        jp, jstate, jm = jstep(jp, jstate, jb)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        assert m["curv_refreshed"] == float(jm["curv_refreshed"])
    n = len(tree_leaves(params))
    assert _close_per_leaf(state.h, jstate.h) == n
    assert _close_per_leaf(p, jp) == n
    # every mixer leaf of both kinds reached the refresh with curvature
    kinds = {JAMBA: ("mamba",), XLSTM: ("mlstm", "slstm")}[arch]
    seen = set()
    for pos, (mixer, _) in enumerate(model.kinds):
        h = state.h["layers"][pos]["mixer"]
        for name in RECURRENT_LEAVES[arch]:
            if name in h:
                assert float(h[name].abs().max()) > 0, (mixer, name)
        if mixer in kinds:
            seen.add(mixer)
            assert all(float(x.abs().max()) > 0 for x in tree_leaves(h)), \
                mixer
    assert seen == set(kinds)


# -- the train driver: the reference's five-fednl-steps criterion -------------


@pytest.mark.parametrize("arch", ARCHS)
def test_train_driver_five_fednl_steps_decrease_the_loss(arch):
    """The port's ``launch.train.train`` on the CPU, the reference test's
    arguments: 5 fednl steps, batch 4, seq 32, lr 1e-3, a refresh every 2
    steps, k = 256; all finite, the last loss below the first."""
    from repro_torch.launch.train import train

    with one_rank_group():
        hist = train(arch, smoke=True, steps=5, batch=4, seq=32, lr=1e-3,
                     optimizer="fednl", log_every=10, refresh_every=2,
                     curvature_k=256, device="cpu")
    assert len(hist) == 5 and all(np.isfinite(h) for h in hist), hist
    assert hist[-1] < hist[0], hist


def test_mamba_scan_backward_keeps_no_chunk_scan():
    """Under autograd each chunk of the scan is checkpointed: the graph
    keeps the chunks' inputs and carried states, not their (B, L, Di, S)
    scans. Counted by the bytes autograd saves over a 3-chunk scan at a
    narrow width: under 3 of one chunk's decays."""
    b, t, di, s, chunk = 1, 3 * 16, 64, 16, 16
    args = [torch.from_numpy(x).requires_grad_(True) for x in _scan_inputs(
        b, t, di, s, seed=0, dtype=np.float32)]
    saved = []

    def pack(x):
        saved.append(x.numel() * x.element_size())
        return x

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        y = mamba._ssm_scan(*args, chunk=chunk)
    one_chunk = b * chunk * di * s * 4
    assert sum(saved) < 3 * one_chunk, (sum(saved), one_chunk)
    y.sum().backward()
    assert all(torch.isfinite(a.grad).all() for a in args)
