"""The mesh's "model" axis for the MoE family, and the refresh's
observation through the per-layer gather, on gloo groups of spawned CPU
ranks (``tests/_torch_dist.py``; one group a mesh shape: (1, 4) and
(2, 2) on 4 ranks, (1, 2) on 2), at reduced widths:

* granite-moe-1b-a400m with 4 experts (expert parallel at M = 2 and 4)
  and a vocab of 515, which no extent divides (the rules replicate the
  tied embedding over "model");
* grok-1-314b with 3 experts (tensor parallel inside each expert at
  M = 2 and 4: d_ff over "model"), gelu, an untied lm head.

The oracles: the reference's own ``tree_param_specs``,
``opt_state_shardings`` and ``cache_specs`` on a ``jax.make_mesh`` of
the same shape over 4 forced host devices (a subprocess); the port
without a mesh in this process (``test_torch_moe.py`` holds it to the
reference's jitted fednl step), with ``n_silos`` = the data extent; and
for the observation route, the whole-tree route it replaces.

Tolerances (f32), as ``test_torch_model_axis.py``'s: the logits within
1e-4 of the largest (measured about 7e-7: the ranks' partial combines or
row-parallel expert outputs are summed over the ranks where one process
sums in one product); six fednl steps, each loss within 1e-5 relative
and each param leaf within 1e-4 of its largest |value| at all but 0.1 %
of its entries, within 5e-2 at every entry; a refresh handed the same
observations, and the observation route against the whole-tree route,
bit for bit; ``generate``'s tokens exactly.
"""

import numpy as np
import pytest
import torch

from _torch_dist import finish_group, moe_axis_all, start_group
from _torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)
from repro_torch.launch.serve import generate
from repro_torch.launch.sharding import check_model_axis
from repro_torch.models import build_model
from repro_torch.tree import tree_leaves, tree_map
from test_torch_model_axis import (ARGV, CACHE, LOSS_REL, PARAM_OUTLIERS,
                                   PARAM_REL, QWEN,
                                   REFRESH_K, SC15, _cfg, _draws,
                                   _finish_reference, _one_process, _pairs,
                                   _placements_of, _start_reference)

GRANITE, GROK = "granite-moe-1b-a400m", "grok-1-314b"
NARROW = dict(d_model=128, d_ff=256)
# (name, arch, overrides of .reduced, fields replaced after)
CONFIGS = [("granite_ep", GRANITE, dict(NARROW, vocab=515), None),
           ("grok_tp", GROK, dict(NARROW, vocab=512, experts=3), None)]
LOGITS = ([(arch, ov, rep) for _, arch, ov, rep in CONFIGS], 2, 80)
# the observation route against the whole-tree one: reduced qwen2
# (every stacked weight on 128-row bounds), starcoder2-15b, and the MoEs
OBSERVED = [(QWEN, {}, None), (SC15, {}, None),
            *[(arch, ov, rep) for _, arch, ov, rep in CONFIGS]]
# (arch, overrides, replace, batch, prompt_len, gen, greedy, seed); a
# dense qwen2 whose vocab (515) no extent divides
GEN_CASES = [(GRANITE, CONFIGS[0][2], None, 2, 5, 7, True, 3),
             (GROK, CONFIGS[1][2], None, 2, 5, 7, False, 3),
             (QWEN, {"vocab": 515}, None, 2, 5, 6, True, 3)]


def _start(shape, tmp_path_factory, observe_shapes, gen=False):
    runs = [(arch, ov, rep, ARGV) for _, arch, ov, rep in CONFIGS]
    refresh = [(arch, ov, rep, *_draws(_cfg(arch, ov, rep), shape[0], i),
                REFRESH_K) for i, (_, arch, ov, rep) in enumerate(CONFIGS)]
    cache = [(arch, ov, rep, *CACHE) for _, arch, ov, rep in CONFIGS]
    return start_group(
        moe_axis_all, shape[0] * shape[1],
        tmp_path_factory.mktemp("moe" + "x".join(map(str, shape))), shape,
        LOGITS if shape != (1, 2) else None,
        (observe_shapes, OBSERVED, REFRESH_K) if observe_shapes else None,
        dict(train_runs=runs if shape != (1, 2) else (),
             refresh_cases=refresh if shape != (1, 2) else (),
             gen_cases=GEN_CASES if gen else (), cache_cases=cache))


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """The three groups and the reference's specs, all started at once:
    (1, 4) with the observation route also on the same ranks as (4, 1),
    (2, 2), and (1, 2) with ``generate``."""
    ref = _start_reference(CONFIGS)
    started = {(1, 4): _start((1, 4), tmp_path_factory, [(1, 4), (4, 1)],
                              gen=True),
               (2, 2): _start((2, 2), tmp_path_factory, [(2, 2)]),
               (1, 2): _start((1, 2), tmp_path_factory, [], gen=True)}
    out = {shape: finish_group(h) for shape, h in started.items()}
    out["reference"] = _finish_reference(ref)
    return out


SHAPES = [(1, 4), (2, 2)]
STEPS = 6
# the runs whose routing flips against one process, and the step: granite
# at (1, 4), one token at step 3, where one process's margin between its
# 2nd and 3rd router probabilities is 7.1e-5 (the drift of a near-tied
# Block-Top-K pick in the step-0 refresh reaches the router by then)
MOE_FLIP = {((1, 4), 0): 3}
NEAR_TIE, FLIP_LOSS_REL = 1e-3, 1e-4
# a near-tied Block-Top-K pick moves a preconditioned entry by up to
# 5.9e-2 of its leaf's max (grok-1 at (1, 4), an expert wo entry;
# test_torch_model_axis.py's dense runs: 3.3e-2)
MOE_PARAM_MISS = 1e-1
CASES = [(shape, c) for shape in SHAPES for c in range(len(CONFIGS))]


def _one_forward(case):
    _, arch, ov, rep = CONFIGS[case]
    cfg = _cfg(arch, ov, rep)
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0))
    _, batch, t = LOGITS
    tokens = torch.randint(0, cfg.vocab, (batch, t),
                           generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        logits, _ = model.forward(params, {"tokens": tokens})
        loss = model.loss_fn(params, {"tokens": tokens,
                                      "targets": torch.roll(tokens, -1, 1)})
    return logits, float(loss)


@pytest.mark.parametrize("shape,case", CASES)
def test_moe_logits_follow_one_process(shape, case, groups):
    """Expert parallel (granite) and tensor parallel inside the experts
    (grok-1): the whole logits and the loss against one process's."""
    got = groups[shape]["logits"][case]
    want, loss = _one_forward(case)
    top = float(want.abs().max())
    assert got["logits"].shape == want.shape
    assert float((got["logits"] - want).abs().max()) <= 1e-4 * top
    assert abs(got["loss"] - loss) <= 1e-5 * abs(loss)


@pytest.mark.parametrize("shape,case", CASES)
def test_params_state_and_cache_lie_as_the_reference_rules_say(
        shape, case, groups):
    """The experts over "model" (granite) or their d_ff (grok-1), the
    router replicated, granite's embedding whole over "model"."""
    want = groups["reference"][f"{CONFIGS[case][0]}@{shape[0]}x{shape[1]}"]
    run = groups[shape]["train"][case]
    model_split = 0
    for field in ("params", "h", "mu", "l"):
        got = run["params_layout"] if field == "params" else \
            run["state_layout"][field]
        for g, w in _pairs(got, want[field]):
            assert g == _placements_of(w, shape), (field, g, w)
            model_split += g[1] != "Replicate"
    assert model_split > 0
    cache = groups[shape]["cache"][case]["placements"]
    assert cache == [_placements_of(w, shape) for w in want["cache"]]
    layout = run["params_layout"]
    experts = layout["layers"][0]["ffn"]["wi"]
    assert experts[1] == ("Shard1" if case == 0 else "Shard3")
    assert layout["layers"][0]["ffn"]["router"][1] == "Replicate"
    assert layout["embed"][1] == ("Replicate" if case == 0 else "Shard0")


def _one_process_routed(arch, ov, rep, n_silos: int):
    """``_one_process`` with each step's own routing: the gate ids and
    top-k margins of the forward of its last gradient call (the step's
    own; a refresh step first takes one a silo)."""
    from _torch_dist import routes_recorded
    from repro_torch.launch import steps as steps_mod

    vg, calls = steps_mod.value_and_grad, []

    def recording(model, params, batch, create_graph=False, split_dims=None):
        with routes_recorded(model.cfg.n_layers) as routes:
            out = vg(model, params, batch, create_graph, split_dims)
        calls.append(routes)
        return out

    steps_mod.value_and_grad = recording
    try:
        want = _one_process(arch, ov, rep, n_silos)
    finally:
        steps_mod.value_and_grad = vg
    at, want["routes"] = 0, []
    for i in range(len(want["loss"])):
        at += (n_silos if i % 2 == 0 else 0) + 1    # refresh_every 2
        want["routes"].append(calls[at - 1])
    assert at == len(calls)
    return want


def _first_flip(got: list, want: list):
    """The first step whose routing differs from one process's, and the
    one process's top-k margins at the tokens that differ, or None."""
    for i, (g, w) in enumerate(zip(got, want)):
        for lg, lw in zip(g, w):
            differ = (lg["ids"] != lw["ids"]).any(-1)
            if bool(differ.any()):
                return i, lw["margin"][differ]
    return None


@pytest.mark.parametrize("shape,case", CASES)
def test_six_fednl_steps_follow_one_process(shape, case, groups):
    """Every step's routing is compared with one process's. Until a
    token's expert pick flips, the losses follow one process within
    ``LOSS_REL``; a flip must come at a near tie of the router (one
    process's k-th and (k+1)-th probabilities within ``NEAR_TIE``), as
    granite's does at (1, 4) (``MOE_FLIP``), and the losses after it stay
    within ``FLIP_LOSS_REL``. Without a flip, the params as
    ``test_torch_model_axis.py`` holds them, but every entry within
    ``MOE_PARAM_MISS`` of its leaf's max."""
    run = groups[shape]["train"][case]
    _, arch, ov, rep = CONFIGS[case]
    want = _one_process_routed(arch, ov, rep, n_silos=shape[0])
    assert run["error"] is None
    assert len(run["routes"]) == STEPS and all(
        len(r) == 2 for r in run["routes"] + want["routes"])
    flip = _first_flip(run["routes"], want["routes"])
    assert (None if flip is None else flip[0]) == MOE_FLIP.get((shape, case))
    until = STEPS if flip is None else flip[0]
    np.testing.assert_allclose(run["loss"][:until], want["loss"][:until],
                               rtol=LOSS_REL, atol=0)
    assert run["loss"][-1] < run["loss"][0]
    if flip is not None:
        assert float(flip[1].max()) <= NEAR_TIE
        np.testing.assert_allclose(run["loss"], want["loss"],
                                   rtol=FLIP_LOSS_REL, atol=0)
        return
    for got, ref in zip(tree_leaves(run["params"]),
                        tree_leaves(want["params"])):
        scale = float(ref.abs().max()) or 1.0
        gap = (got - ref).abs()
        assert float((gap > PARAM_REL * scale).float().mean()) <= PARAM_OUTLIERS
        assert float(gap.max()) <= MOE_PARAM_MISS * scale


@pytest.mark.parametrize("shape", SHAPES)
def test_the_router_and_every_leaf_whole_over_model_agree(shape, groups):
    """The router, norms and (granite) the replicated embedding: the same
    first-step gradient (torch.equal) and the same value after six steps
    on every model rank."""
    for run in groups[shape]["train"]:
        assert run["n_replicated"] > 0
        assert run["replicated_grads_equal"]
        assert run["replicated_params_equal"]


@pytest.mark.parametrize("shape,case", CASES)
def test_refresh_on_expert_shards_equals_one_process_bit_for_bit(
        shape, case, groups):
    from repro_torch.second_order.fednl_precond import (FedNLPrecondOptimizer,
                                                        FedNLPrecondState)

    got = groups[shape]["refresh"][case]
    _, arch, ov, rep = CONFIGS[case]
    h, obs = _draws(_cfg(arch, ov, rep), shape[0], case)
    opt = FedNLPrecondOptimizer(k_per_block=REFRESH_K)
    want = opt.refresh(FedNLPrecondState(0, tree_map(torch.from_numpy, h),
                                         None, None),
                       tree_map(torch.from_numpy, obs))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got["h"]),
                                                 tree_leaves(want.h)))
    assert all(torch.equal(a, b) for a, b in zip(got["l"],
                                                 tree_leaves(want.l)))
    route = got["routes"]["params/layers/0/ffn/wi"]
    # granite's expert shards lie on tile bounds (E / M experts of 128
    # rows); grok-1's d_ff columns (256 / M) only at M = 2
    assert route == ("tiles" if case == 0 or shape == (2, 2) else "gathered")


@pytest.mark.parametrize("shape,case", [(s, c) for s in [(1, 2), (1, 4)]
                                        for c in range(len(GEN_CASES))])
def test_generate_is_one_process(shape, case, groups):
    import repro_torch.launch.serve as serve_mod

    got = groups[shape]["generate"][case]
    arch, ov, rep, batch, prompt_len, gen, greedy, seed = GEN_CASES[case]
    get = serve_mod.get_config
    serve_mod.get_config = lambda a, smoke=True: _cfg(arch, ov, rep)
    try:
        want = generate(arch, smoke=True, batch=batch, prompt_len=prompt_len,
                        gen=gen, seed=seed, greedy=greedy, device="cpu")
    finally:
        serve_mod.get_config = get
    assert got.shape == (batch, prompt_len + gen) and torch.equal(got, want)


# -- the refresh's observation through the per-layer gather ---------------------------

OBSERVE_RUNS = [((1, 4), i) for i in range(len(OBSERVED))] + \
    [((4, 1), i) for i in range(len(OBSERVED))] + \
    [((2, 2), i) for i in range(len(OBSERVED))]


@pytest.mark.parametrize("shape,case", OBSERVE_RUNS)
def test_the_observation_route_refreshes_as_the_whole_tree_route(
        shape, case, groups):
    """The first refresh's H and l through ``silo_gradients`` and
    ``refresh_grads`` (leaf by leaf, large stacked leaves a layer at a
    time) equal the whole-tree route's bit for bit, with the data axis
    alone (4, 1), with the model axis alone (1, 4) and with both."""
    recs = groups[(1, 4) if shape != (2, 2) else (2, 2)]["observe"]
    rec = [r for r in recs if tuple(r["shape"]) == shape][case]
    assert rec["arch"] == OBSERVED[case][0]
    # the layer route is H's gather over "data", a slice at a time
    assert (rec["layered"] > 0) == (shape[0] > 1)
    for field in ("h", "l"):
        assert all(torch.equal(a, b) for a, b in zip(
            tree_leaves(rec["grads"][field]), tree_leaves(rec["whole"][field])))


# -- what the axis still refuses ------------------------------------------------------


def test_a_moe_whose_experts_and_d_ff_do_not_split_is_refused():
    """Expert parallel needs no d_ff split; where neither the experts nor
    d_ff divide, the rules would replicate the experts, and no layer
    computes them whole: refused before any work."""
    import dataclasses

    cfg = dataclasses.replace(_cfg(GROK, NARROW, None), d_ff=250)
    check_model_axis(cfg, {"data": 1, "model": 4})       # 4 experts split
    with pytest.raises(NotImplementedError, match="d_ff = 250"):
        check_model_axis(cfg, {"data": 1, "model": 8})
