"""The port's MoE (granite-moe-1b-a400m, grok-1-314b) against the JAX
package, on the CPU: the configs, ``param_shapes`` at full size, the
input shapes, ``init_params``' tree and laws (the f32 router), the
router (``_route``: gate ids, ``dispatch`` and ``combine``, the aux
loss; ties to the lower expert index, as ``jax.lax.top_k``), the
by-index build of ``dispatch`` and ``combine`` bit for bit against the
reference's one-hot formulation, ``moe_forward`` in f32 and bf16 (with
zero-padded last groups), reduced granite and grok-1 whole in f32
(forward on both attention branches, the loss with its aux term, the
gradient at T=600, decode, greedy ``generate``) and the fednl train step
on reduced granite against the reference's jitted step. Inputs come
from numpy seeds, weights from the reference's ``init_params``; the
reference's ``moe_forward`` is called directly, without a sharder.

Whole-model MoE is held in f32 only. In bf16 the two frameworks round at
other places, a layer's drift can flip a near-tie among the router's
top-k, and the token then takes other experts: the routes differ by
design, not by fault. bf16 is held at the layer (``moe_forward`` on the
same inputs) within the bf16 tolerance of ``_torch_lm``. Tolerances:
``combine`` and the aux loss to 1e-6 (f32 softmax in two orders); gate
ids and ``dispatch`` exact; outputs as ``_torch_lm.close``.
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_lm import (  # noqa: F401 (fixture)
    as_np,
    batches,
    check_grads_against_reference,
    check_param_shapes_at_full_size,
    close,
    jax_decode,
    models,
    no_activation_sharder,
    tokens,
)
from _torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

from repro import checkpoint as jax_checkpoint
from repro.configs import get_config as jax_get_config
from repro.launch import shapes as jax_shapes
from repro.launch.steps import make_optimizer as jax_make_optimizer
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.models import mlp as jax_mlp
from repro.models.transformer import build_model as jax_build_model
from repro_torch import checkpoint
from repro_torch.configs import get_config, granite_moe_1b_a400m, grok_1_314b
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import LAUNCHES
from repro_torch.launch import shapes
from repro_torch.launch.serve import generate
from repro_torch.launch.steps import (
    make_optimizer,
    make_prefill,
    make_serve_step,
    make_train_step,
)
from repro_torch.models import build_model
from repro_torch.models import mlp
from repro_torch.tree import tree_leaves, tree_map

pytestmark = pytest.mark.usefixtures("no_activation_sharder")

GRANITE, GROK = "granite-moe-1b-a400m", "grok-1-314b"
ARCHS = [GRANITE, GROK]
PARAM_SHAPES = {GRANITE: granite_moe_1b_a400m.param_shapes,
                GROK: grok_1_314b.param_shapes}
DTYPES = ["float32", "bfloat16"]


def _cfgs(arch: str, dtype: str = "float32", **moe):
    """(reference, port) reduced configs of ``arch`` in ``dtype``, the MoE
    fields replaced by ``moe``."""
    jcfg = jax_get_config(arch, smoke=True)
    cfg = get_config(arch, smoke=True)
    jcfg = dataclasses.replace(jcfg, dtype=dtype,
                               moe=dataclasses.replace(jcfg.moe, **moe))
    cfg = dataclasses.replace(cfg, dtype=dtype,
                              moe=dataclasses.replace(cfg.moe, **moe))
    return jcfg, cfg


# -- configs and shapes --------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch):
    for smoke in (False, True):
        got, want = get_config(arch, smoke=smoke), jax_get_config(
            arch, smoke=smoke)
        for f in dataclasses.fields(got):
            a, b = getattr(got, f.name), getattr(want, f.name)
            if f.name == "moe":
                a, b = dataclasses.asdict(a), dataclasses.asdict(b)
            assert a == b, f.name
        assert got.hd == want.hd and got.family == "moe"
    small = get_config(arch, smoke=True).moe
    assert (small.num_experts, small.top_k, small.group_size) == (4, 2, 64)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_shapes_match_reference_at_full_size(arch):
    """The experts' weights (layers, E, d, ff) on axis 1, the router an
    f32 leaf (layers, d, E) in a bf16 tree; granite ties its embeddings,
    grok-1 has a gelu MLP (no ``wg``) and an ``lm_head``."""
    assert check_param_shapes_at_full_size(arch, PARAM_SHAPES[arch]) == 12
    cfg = get_config(arch)
    ffn = PARAM_SHAPES[arch]()["layers"][0]["ffn"]
    e = cfg.moe.num_experts
    assert ffn["router"] == ((cfg.n_layers, cfg.d_model, e), torch.float32)
    assert ffn["wi"] == ((cfg.n_layers, e, cfg.d_model, cfg.d_ff),
                         torch.bfloat16)
    assert ("wg" in ffn) == (arch == GRANITE)


@pytest.mark.parametrize("arch", ARCHS)
def test_input_shapes_match_reference(arch):
    """skip_reason, the train and prefill batch stand-ins and the decode
    stand-ins, leaf by leaf, for every assigned shape."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for name, shape in shapes.SHAPES.items():
        jshape = jax_shapes.SHAPES[name]
        assert shapes.skip_reason(cfg, shape) == jax_shapes.skip_reason(
            jcfg, jshape)
        if shape.kind != "decode":
            got = shapes.token_batch_specs(cfg, shape)
            want = jax_shapes.token_batch_specs(jcfg, jshape)
            assert {k: tuple(v.shape) for k, v in got.items()} == {
                k: v.shape for k, v in want.items()}
            continue
        if name != "decode_32k":
            continue
        got = shapes.decode_input_specs(cfg, shape, build_model(cfg))
        want = jax_shapes.decode_input_specs(jcfg, jshape,
                                             jax_build_model(jcfg))
        assert ([tuple(x.shape) for x in tree_leaves(got["cache"])]
                == [x.shape for x in jax.tree.leaves(want["cache"])])


def _full_width_one_layer(arch: str):
    """(port, reference) bf16 configs: granite at its published width
    with one layer (the laws do not depend on the depth but through wo's
    scale, which the check reads from the config); grok-1's expert
    tensors at full width would take 6 GB a layer, so grok-1 reduced."""
    if arch == GRANITE:
        pair = (get_config(arch), jax_get_config(arch))
        return tuple(dataclasses.replace(c, n_layers=1, dtype="bfloat16")
                     for c in pair)
    return tuple(dataclasses.replace(c, dtype="bfloat16") for c in (
        get_config(arch, smoke=True), jax_get_config(arch, smoke=True)))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_dtypes_and_laws(arch):
    """The drawn tree has ``param_shapes``' paths, shapes and dtypes and
    the reference's (``eval_shape``); the router is f32 in a bf16 model;
    norms are ones; each weight has the reference's std: 0.02 for the
    embeddings, scale / sqrt(d_in) for dense and expert weights (wo's
    scale 1 / sqrt(2 n_layers)), within 5 %."""
    cfg, jcfg = _full_width_one_layer(arch)
    want = jax.eval_shape(jax_build_model(jcfg).init_params,
                          jax.random.PRNGKey(0))
    params = build_model(cfg).init_params(torch.Generator().manual_seed(0))
    n = []

    def check(p, spec, ref):
        assert tuple(p.shape) == tuple(spec.shape) == tuple(ref.shape)
        assert p.dtype == spec.dtype
        assert str(p.dtype).removeprefix("torch.") == str(ref.dtype)
        n.append(1)

    tree_map(check, params, PARAM_SHAPES[arch](cfg), want)
    assert len(n) == len(jax.tree.leaves(want)) == 12
    layer = params["layers"][0]
    ffn = layer["ffn"]
    assert ffn["router"].dtype == torch.float32
    assert ffn["wi"].dtype == torch.bfloat16
    for w in (params["norm_f"]["w"], layer["norm1"]["w"], layer["norm2"]["w"]):
        assert torch.equal(w, torch.ones_like(w))
    d, ff = cfg.d_model, cfg.d_ff
    laws = [(params["embed"], 0.02), (ffn["router"], 1 / math.sqrt(d)),
            (ffn["wi"], 1 / math.sqrt(d)),
            (ffn["wo"], 1 / math.sqrt(2 * cfg.n_layers) / math.sqrt(ff)),
            (layer["mixer"]["wq"], 1 / math.sqrt(d))]
    for w, std in laws:
        got = float(w.float().std())
        assert abs(got - std) <= 0.05 * std, (tuple(w.shape), got, std)
    # experts are drawn one by one: no two share their weights
    assert not torch.equal(ffn["wi"][0, 0], ffn["wi"][0, 1])


# -- the router -------------------------------------------------------------------


def _logits(case: str, seed: int = 0):
    """(logits (G, E) f32, top_k, capacity factor) of a routing case."""
    rng = np.random.default_rng(seed)
    if case == "reduced":
        return rng.standard_normal((64, 4)).astype(np.float32), 2, 1.25
    if case == "granite":
        return rng.standard_normal((512, 32)).astype(np.float32), 8, 1.25
    if case == "ties":        # integer logits: many ties, some whole rows
        x = rng.integers(0, 3, (96, 8)).astype(np.float32)
        x[::7] = 0.0
        return x, 3, 1.0
    assert case == "tight"    # half the slots: many drops
    return rng.standard_normal((128, 8)).astype(np.float32), 2, 0.5


CASES = ["reduced", "granite", "ties", "tight"]


def _route_cfgs(e: int, k: int, cf: float):
    jcfg, cfg = _cfgs(GRANITE, num_experts=e, top_k=k, capacity_factor=cf)
    return jcfg, cfg


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", CASES)
def test_route_matches_reference(case, dtype):
    """Gate ids and ``dispatch`` exact; ``combine`` and the aux loss to
    1e-6. bf16 logits are cast to f32 by both, as the router does."""
    x, k, cf = _logits(case)
    g, e = x.shape
    jcfg, cfg = _route_cfgs(e, k, cf)
    jx = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bfloat16"
                               else jnp.float32)
    px = torch.from_numpy(x).to(getattr(torch, dtype))
    jd, jc, ja = jax_mlp._route(jx, jcfg)
    d, c, a = mlp._route(px, cfg)
    assert d.shape == (g, e, mlp.capacity(cfg, g)) == jd.shape
    _, want_ids = jax.lax.top_k(jax.nn.softmax(jx.astype(jnp.float32)), k)
    _, got_ids = mlp.top_k_lower_index(torch.softmax(px.float(), dim=-1), k)
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(float(a), float(ja), rtol=1e-6, atol=1e-6)
    if case == "tight":
        assert float(d.sum()) < g * k       # slots were dropped


def _route_one_hot(router_logits, cfg):
    """``_route`` of one group (G, E) by the reference's formulation, the
    (k * G, E, C) one-hot products summed over the slots: the yardstick
    of the by-index build, which must equal it bit for bit."""
    g, e = router_logits.shape
    k, c = cfg.moe.top_k, mlp.capacity(cfg, g)
    probs = torch.softmax(router_logits.float(), dim=-1)
    gate_vals, gate_ids = mlp.top_k_lower_index(probs, k)
    gate_vals = gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True)
    masks = torch.nn.functional.one_hot(gate_ids, e).float()      # (G, k, E)
    flat = masks.transpose(0, 1).reshape(k * g, e)
    pos = torch.cumsum(flat, dim=0) - flat
    keep = (pos < c) * flat
    pos_oh = torch.nn.functional.one_hot(
        pos.long(), max(c, int(pos.max()) + 1))[..., :c]
    disp = (keep[..., None] * pos_oh.float()).reshape(k, g, e, c).transpose(0, 1)
    combine = torch.einsum("gk,gkec->gec", gate_vals, disp)
    frac_tokens = torch.mean(torch.sum(masks, dim=1), dim=0)
    aux = e * torch.sum(frac_tokens * torch.mean(probs, dim=0))
    return torch.sum(disp, dim=1), combine, aux


@pytest.mark.parametrize("case", CASES)
def test_route_by_index_equals_one_hot_build(case):
    """The by-index build is the (k * G, E, C) one-hot formulation's
    result bit for bit, dispatch, combine and aux, on one group and on a
    stack of groups routed each on its own."""
    x, k, cf = _logits(case)
    _, cfg = _route_cfgs(x.shape[1], k, cf)
    px = torch.from_numpy(x)
    got = mlp._route(px, cfg)
    want = _route_one_hot(px, cfg)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    stack = torch.from_numpy(np.stack([_logits(case, s)[0] for s in range(3)]))
    d, c, a = mlp._route(stack, cfg)
    for i in range(3):
        di, ci, ai = _route_one_hot(stack[i], cfg)
        assert torch.equal(d[i], di) and torch.equal(c[i], ci)
        assert torch.equal(a[i], ai)


def test_top_k_ties_pick_the_lower_index():
    """As ``jax.lax.top_k``: top_k(ones(4), 2) picks [0, 1]; a uniform
    row (a zero-padded token's probabilities) picks experts 0..k-1."""
    _, want = jax.lax.top_k(jnp.ones(4), 2)
    _, got = mlp.top_k_lower_index(torch.ones(4), 2)
    assert got.tolist() == np.asarray(want).tolist() == [0, 1]
    row = torch.softmax(torch.zeros(1, 32), dim=-1)
    assert mlp.top_k_lower_index(row, 8)[1].tolist() == [list(range(8))]
    _, mixed = mlp.top_k_lower_index(torch.tensor([0.1, 0.3, 0.1, 0.3, 0.2]), 3)
    assert mixed.tolist() == [1, 3, 4]


# -- moe_forward --------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _layer(arch: str, dtype: str):
    """(reference params, port params, reference cfg, port cfg) of one
    reduced MoE layer from the reference's ``moe_init``."""
    jcfg, cfg = _cfgs(arch, dtype)
    jp = jax_mlp.moe_init(jax.random.PRNGKey(3), jcfg)
    p = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jp, p, jcfg, cfg


@pytest.mark.parametrize("bt", [(2, 64), (3, 50), (2, 1)])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_forward_matches_reference(arch, dtype, bt):
    """y to ``close``'s tolerance and the aux loss to 1e-6, at B*T a
    multiple of the group size (2 groups of 64), not one (150 tokens: a
    last group of 22 tokens and 42 zero pads, whose tied slot 0 goes
    before the real tokens' slot 1) and a decode step (one group of 2)."""
    jp, p, jcfg, cfg = _layer(arch, dtype)
    b, t = bt
    x = np.random.default_rng(b * t).standard_normal(
        (b, t, cfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x).astype(jcfg.jdtype)
    want, jaux = jax_mlp.moe_forward(jp, jx, jcfg)
    got, aux = mlp.moe_forward(p, torch.from_numpy(x).to(cfg.tdtype), cfg)
    assert got.shape == (b, t, cfg.d_model) and got.dtype == cfg.tdtype
    assert p["router"].dtype == torch.float32
    close(got, want, dtype)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6, atol=1e-6)


def test_pads_take_their_tied_experts_first():
    """150 tokens in groups of 64: the 42 pads of the last group route to
    experts 0 and 1 (ties to the lower index), and their slot 0 fills
    expert 0 before the 22 real tokens' second choices; the dispatch
    equals the reference's bit for bit."""
    jp, p, jcfg, cfg = _layer(GRANITE, "float32")
    x = np.zeros((192, cfg.d_model), np.float32)
    x[:150] = np.random.default_rng(150).standard_normal((150, cfg.d_model))
    groups = torch.from_numpy(x).reshape(3, 64, cfg.d_model)
    logits = torch.einsum("ngd,de->nge", groups, p["router"])
    d, _, _ = mlp._route(logits, cfg)
    pads = d[2, 22:]                                # (42, E, C)
    assert not pads[:, 2:].any()                    # experts 0 and 1 only
    assert int(d[2, :, 0].sum()) == mlp.capacity(cfg, 64)   # 0 is full
    jd, _, _ = jax.vmap(lambda lg: jax_mlp._route(lg, jcfg))(
        jnp.asarray(logits.numpy()))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))


# -- reduced granite and grok-1, whole, in f32 ----------------------------------------


@pytest.mark.parametrize("t", [64, 600])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_reference(arch, t):
    """Logits to 1e-4 at T=64 (``_sdpa``) and T=600 (the port's K9 op
    against the reference's ``_sdpa_chunked``; 1,200 tokens make 19
    groups, the last padded), the summed aux loss to 1e-5 and
    ``loss_fn`` (cross-entropy + 0.01 aux) to 1e-5."""
    jmodel, jparams, model, params = models(arch, "float32")
    toks = tokens(t, 2, t, model.cfg.vocab)
    jb, pb = batches(toks, toks[:, ::-1].copy(), {})
    want, jaux = jmodel.forward(jparams, jb)
    with torch.no_grad():
        got, aux = model.forward(params, pb)
        loss = model.loss_fn(params, pb)
    close(got, want, "float32")
    assert float(aux) > 0
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    np.testing.assert_allclose(float(loss), float(jmodel.loss_fn(jparams, jb)),
                               rtol=1e-5)
    assert make_prefill(model)(params, pb).shape == (2, t, model.cfg.vocab)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_grad_matches_reference_above_512_tokens(arch):
    """At T=600 both sides differentiate their ``_sdpa_chunked`` and the
    MoE (through ``combine``'s gate values and the aux loss's
    probabilities); no K9 launch. Every leaf within 1e-4 of its largest
    |grad|."""
    jmodel, jparams, model, params = models(arch, "float32")
    before = dict(LAUNCHES)
    n = check_grads_against_reference(jmodel, jparams, model, params,
                                      tokens(13, 2, 600, model.cfg.vocab))
    assert n == 12 and LAUNCHES == before


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference(arch):
    """16 tokens through the serve step: each step routes the B = 2
    tokens as one group (C = 1 or 2 slots), as the reference's."""
    jmodel, jparams, model, params = models(arch, "float32")
    toks = tokens(21, 2, 16, model.cfg.vocab)
    want = jax_decode(jmodel, jparams, toks, 20)
    serve = make_serve_step(model)
    cache = model.init_cache(2, 20, "cpu")
    for pos in range(16):
        lg, cache = serve(params, cache, torch.from_numpy(
            toks[:, pos:pos + 1]).long(), pos)
        close(lg[:, 0], want[pos], "float32")


def test_decode_matches_forward_when_nothing_is_dropped():
    """With capacity_factor = E / top_k every expert has a slot for every
    token, so no grouping drops one: decode (groups of B) equals the
    forward (groups of 64) at every position, to 1e-4. At the published
    capacity they differ by design (other groups drop other tokens)."""
    cfg = get_config(GRANITE, smoke=True)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(2))
    toks = torch.from_numpy(tokens(4, 2, 40, cfg.vocab)).long()
    fwd = make_prefill(model)(params, {"tokens": toks})
    serve = make_serve_step(model)
    cache = model.init_cache(2, 40, "cpu")
    for pos in range(40):
        lg, cache = serve(params, cache, toks[:, pos:pos + 1], pos)
        torch.testing.assert_close(lg[:, 0], fwd[:, pos], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_greedy_matches_reference_decode_loop(arch):
    """``generate(params=...)`` takes its dtype from ``embed``, not the
    f32 router; its greedy tokens are the reference's argmax along them."""
    jmodel, jparams, model, params = models(arch, "float32")
    prompt_len, n_gen = 6, 8
    seqs = generate(arch, smoke=True, batch=2, prompt_len=prompt_len,
                    gen=n_gen, seed=7, greedy=True, device="cpu",
                    params=params)
    toks = seqs.numpy().astype(np.int32)
    logits = jax_decode(jmodel, jparams, toks[:, :-1], prompt_len + n_gen)
    for i in range(n_gen):
        np.testing.assert_array_equal(toks[:, prompt_len + i],
                                      logits[prompt_len - 1 + i].argmax(-1))


def test_bf16_generate_keeps_the_embedding_dtype():
    """A bf16 MoE tree (router f32): ``generate`` serves in bf16."""
    _, _, model, params = models(GRANITE, "bfloat16")
    assert params["layers"][0]["ffn"]["router"].dtype == torch.float32
    seqs = generate(GRANITE, smoke=True, batch=2, prompt_len=4, gen=3,
                    seed=1, greedy=True, device="cpu", params=params)
    assert seqs.shape == (2, 7)


# -- the fednl train step on reduced granite ----------------------------------------

TINY = dict(n_layers=1, d_model=64, d_ff=128, vocab=128)


@functools.lru_cache(maxsize=None)
def _tiny_ref():
    model = jax_build_model(jax_get_config(GRANITE).reduced(**TINY),
                            use_remat=True)
    return model, model.init_params(jax.random.PRNGKey(0))


def _tiny_batch(seed: int, b: int = 4, t: int = 32):
    toks = jax.random.randint(jax.random.PRNGKey(seed), (b, t), 0,
                              TINY["vocab"])
    jb = {"tokens": toks, "targets": jnp.roll(toks, -1, axis=1)}
    return jb, {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}


def _close_per_leaf(got_tree, want_tree, rel=1e-4):
    def check(g, w):
        w = np.asarray(jnp.asarray(w).astype(jnp.float32))
        gap = float(np.max(np.abs(as_np(g) - w)))
        assert gap <= rel * max(float(np.max(np.abs(w))), 1e-30), w.shape

    tree_map(check, got_tree, want_tree)


def test_fednl_train_step_matches_reference():
    """``make_train_step`` with fednl (exact Block-Top-K: k = block^2 = 64,
    2 silos, a refresh every 2 steps) on the reference's ``_tiny``
    granite (1 layer, d 64, 4 experts top-2, f32): loss, H and params
    after 3 steps within 1e-4 of each leaf's largest |value| of the
    reference's jitted step; the 4-D expert leaves and the router reach
    the refresh."""
    jmodel, jparams = _tiny_ref()
    model = build_model(get_config(GRANITE).reduced(**TINY), use_remat=True)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               device="cpu")
    opt = make_optimizer("fednl", 1e-2, k_per_block=64, block=8)
    step = make_train_step(model, opt, refresh_every=2, n_silos=2)
    jopt = jax_make_optimizer("fednl", 1e-2, k_per_block=64, block=8)
    jstep = jax.jit(jax_make_train_step(jmodel, jopt, refresh_every=2,
                                        n_silos=2))
    state, jstate = opt.init(params), jopt.init(jparams)
    p, jp = params, jparams
    for i in range(3):
        jb, b = _tiny_batch(i)
        p, state, m = step(p, state, b)
        jp, jstate, jm = jstep(jp, jstate, jb)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        assert m["curv_refreshed"] == float(jm["curv_refreshed"])
    _close_per_leaf(state.h, jstate.h)
    _close_per_leaf(p, jp)
    h = state.h["layers"][0]["ffn"]
    assert h["wi"].dim() == 4 and float(h["wi"].abs().max()) > 0
    assert float(h["router"].abs().max()) > 0


@pytest.mark.parametrize("name", ["adamw", "fednl"])
def test_optimizers_keep_each_leafs_dtype_in_a_bf16_moe_tree(name):
    """A bf16 ``_tiny`` granite (its router f32): the optimizer's state
    and two train steps keep every parameter in its own dtype (AdamW's
    moments in the parameter's, fednl's curvature in f32), finite; the
    first loss equals the reference's on the same weights to 1e-3."""
    jcfg = dataclasses.replace(jax_get_config(GRANITE).reduced(**TINY),
                               dtype="bfloat16")
    jmodel = jax_build_model(jcfg, use_remat=True)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(get_config(GRANITE).reduced(**TINY),
                              dtype="bfloat16")
    model = build_model(cfg, use_remat=True)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               device="cpu")
    router = params["layers"][0]["ffn"]["router"]
    assert router.dtype == torch.float32
    dtypes = [p.dtype for p in tree_leaves(params)]
    kw = dict(k_per_block=64, block=8) if name == "fednl" else {}
    opt = make_optimizer(name, 1e-2, **kw)
    step = make_train_step(model, opt, refresh_every=1, n_silos=2)
    state = opt.init(params)
    if name == "adamw":
        assert [m.dtype for m in tree_leaves(state.mu)] == dtypes
    else:
        assert all(h.dtype == torch.float32 for h in tree_leaves(state.h))
    want = float(jax.jit(jmodel.loss_fn)(jparams, _tiny_batch(0)[0]))
    p = params
    for i in range(2):
        p, state, m = step(p, state, _tiny_batch(i)[1])
        if i == 0:
            np.testing.assert_allclose(float(m["loss"]), want, rtol=1e-3)
    assert [x.dtype for x in tree_leaves(p)] == dtypes
    assert all(bool(torch.isfinite(x.float()).all()) for x in tree_leaves(p))


@pytest.mark.parametrize("direction", ["port_to_reference",
                                       "reference_to_port"])
def test_checkpoints_keep_the_f32_router_across_packages(tmp_path,
                                                         direction):
    """A bf16 granite tree with its f32 router saved by one package and
    restored by the other: every leaf bit for bit, in its own dtype."""
    jcfg = dataclasses.replace(jax_get_config(GRANITE).reduced(**TINY),
                               dtype="bfloat16")
    jparams = jax_build_model(jcfg).init_params(jax.random.PRNGKey(1))
    tree = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    assert tree["layers"][0]["ffn"]["router"].dtype == torch.float32
    assert tree["layers"][0]["ffn"]["wi"].dtype == torch.bfloat16
    path = str(tmp_path / "ckpt")
    if direction == "port_to_reference":
        checkpoint.save(path, tree, step=3)
        got, step = jax_checkpoint.restore(path, jparams)
        got = params_from_numpy(jax.tree.map(np.asarray, got), device="cpu")
    else:
        jax_checkpoint.save(path, jparams, step=3)
        got, step = checkpoint.restore(path, tree)
    assert step == 3

    def same(a, b):
        assert a.dtype == b.dtype and torch.equal(a, b)

    tree_map(same, got, tree)
