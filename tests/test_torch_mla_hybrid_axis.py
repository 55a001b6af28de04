"""The mesh's "model" axis for MLA (minicpm3-4b) and for the hybrid
family's Mamba mixers (jamba-1.5-large-398b), on gloo groups of spawned
CPU ranks (``tests/_torch_dist.py``; one group a mesh shape: (1, 4) and
(2, 2) on 4 ranks, (1, 2) on 2), at reduced widths (d 128, d_ff 256,
vocab 512):

* minicpm3-4b with 4 heads (kv_lora 32): its heads split at M = 2 and 4,
  ``wuk``/``wuv`` on their 32 latent rows;
* the same with 6 heads: at M = 4 the heads do not split (``wuq``'s 288
  columns do, 72 a rank), so every rank computes every head;
* jamba with a period of Mamba + MLP and GQA + a 4-expert MoE (expert
  parallel at M = 2 and 4): Di = 256, ``win``'s 512 columns over
  "model", ``wbc``'s 32 and ``a_log``'s 16 state columns too.

The oracles: the reference's own ``tree_param_specs``,
``opt_state_shardings`` and ``cache_specs`` on a ``jax.make_mesh`` of
the same shape over 4 forced host devices (a subprocess); the port
without a mesh in this process (``test_torch_mla.py`` and
``test_torch_ssm*.py`` hold it to the reference), with ``n_silos`` = the
data extent.

Tolerances (f32), as ``test_torch_moe_axis.py``'s: the logits within
1e-4 of the largest (at T = 600, MLA's chunked prefill and the SSM's
chunked scan); six fednl steps, each loss within 1e-5 relative up to a
first router flip, which must come at a near tie; every leaf held whole
over "model" equal bit for bit on every model rank (the gradient of the
first step and the value after the sixth: MLA's down-projections, the
Mamba mixer's ``conv_b``, ``dt_bias``, ``d_skip`` and ``wdt``); a
refresh handed the same observations bit for bit; ``generate``'s tokens
exactly, over a latent cache split on its sequence and over a whole one.
"""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_dist import finish_group, moe_axis_all, start_group
from _torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)
from repro_torch.configs import get_config
from repro_torch.launch.serve import generate
from repro_torch.launch.sharding import check_model_axis
from repro_torch.second_order.fednl_precond import (FedNLPrecondOptimizer,
                                                    FedNLPrecondState)
from repro_torch.tree import tree_leaves, tree_map
from test_torch_model_axis import (ARGV, CACHE, LOSS_REL, REFRESH_K, _cfg,
                                   _draws, _finish_reference, _pairs,
                                   _placements_of, _start_reference)
from test_torch_moe_axis import (FLIP_LOSS_REL, NEAR_TIE, _first_flip,
                                 _one_process_routed)

MINICPM3, JAMBA = "minicpm3-4b", "jamba-1.5-large-398b"
NARROW = dict(d_model=128, d_ff=256)
SIX_HEADS = dict(n_heads=6, kv_heads=6)
# (name, arch, overrides of .reduced, fields replaced after)
CONFIGS = [("minicpm3", MINICPM3, NARROW, None),
           ("minicpm3_6_heads", MINICPM3, NARROW, SIX_HEADS),
           ("jamba", JAMBA, NARROW, None)]
LOGITS = ([(arch, ov, rep) for _, arch, ov, rep in CONFIGS], 1, 600)
# (arch, overrides, replace, batch, prompt_len, gen, greedy, seed): the
# cache's S is prompt_len + gen, 12 splits over 2 and 4, 11 over neither
GEN_CASES = [(MINICPM3, NARROW, None, 2, 5, 7, True, 3),
             (MINICPM3, NARROW, None, 2, 5, 6, False, 3),
             (MINICPM3, NARROW, SIX_HEADS, 2, 5, 7, True, 3),
             (JAMBA, NARROW, None, 2, 5, 7, False, 3)]


def _start(shape, tmp_path_factory, gen=False):
    runs = [(arch, ov, rep, ARGV) for _, arch, ov, rep in CONFIGS]
    refresh = [(arch, ov, rep, *_draws(_cfg(arch, ov, rep), shape[0], i),
                REFRESH_K) for i, (_, arch, ov, rep) in enumerate(CONFIGS)]
    cache = [(arch, ov, rep, *CACHE) for _, arch, ov, rep in CONFIGS]
    train = shape != (1, 2)
    return start_group(
        moe_axis_all, shape[0] * shape[1],
        tmp_path_factory.mktemp("mla" + "x".join(map(str, shape))), shape,
        LOGITS if train else None, None,
        dict(train_runs=runs if train else (),
             refresh_cases=refresh if train else (),
             gen_cases=GEN_CASES if gen else (), cache_cases=cache))


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """The three groups and the reference's specs, all started at once:
    (1, 4) and (1, 2) with ``generate``, (2, 2)."""
    ref = _start_reference(CONFIGS)
    started = {(1, 4): _start((1, 4), tmp_path_factory, gen=True),
               (2, 2): _start((2, 2), tmp_path_factory),
               (1, 2): _start((1, 2), tmp_path_factory, gen=True)}
    out = {shape: finish_group(h) for shape, h in started.items()}
    out["reference"] = _finish_reference(ref)
    return out


SHAPES = [(1, 4), (2, 2)]
STEPS = 6
# the runs whose routing flips against one process, and the step
FLIPS = {}
CASES = [(shape, c) for shape in SHAPES for c in range(len(CONFIGS))]


def _one_forward(case):
    _, arch, ov, rep = CONFIGS[case]
    cfg = _cfg(arch, ov, rep)
    from repro_torch.models import build_model

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
def test_logits_follow_one_process(shape, case, groups):
    """A 600-token prefill: MLA's chunked attention on the rank's heads
    (or every head), the Mamba mixer's chunked scan on its channels."""
    got = groups[shape]["logits"][case]
    want, loss = _one_forward(case)
    top = float(want.abs().max())
    assert got["logits"].shape == want.shape
    assert float((got["logits"] - want).abs().max()) <= 1e-4 * top
    assert abs(got["loss"] - loss) <= 1e-5 * abs(loss)


@pytest.mark.parametrize("shape,case", CASES)
def test_params_state_and_cache_lie_as_the_reference_rules_say(
        shape, case, groups):
    """Leaf by leaf against the reference's specs; then what the layers
    must move: MLA's ``wuk`` split on its latent rows and ``wdq`` whole
    over "model"; the Mamba mixer's ``win`` on its 2 Di columns, ``wbc``
    and ``a_log`` on their columns, ``wdt`` whole, ``conv`` and ``wout``
    on Di."""
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
    layout = run["params_layout"]["layers"][0]["mixer"]
    if CONFIGS[case][1] == MINICPM3:
        assert layout["wuk"][1] == "Shard1" and layout["wuq"][1] == "Shard2"
        assert layout["wo"][1] == "Shard1" and layout["wdq"][1] == "Replicate"
    else:
        assert [layout[n][1] for n in ("win", "wbc", "a_log", "wdt", "conv",
                                       "wout", "conv_b")] == [
            "Shard2", "Shard2", "Shard2", "Replicate", "Shard2", "Shard1",
            "Replicate"]


def test_the_caches_take_each_layout(groups):
    """MLA's latent cache over "model" on its sequence where S divides
    (S = 12 at M = 2 and 4); the Mamba layer's conv window and state on
    Di (256 channels), the jamba GQA layer's 4 KV heads."""
    b, s = CACHE
    for shape, m in (((1, 4), 4), ((1, 2), 2)):
        mc = groups[shape]["cache"][0]["local"]      # 2 layers of 1
        assert mc == [(2, b, s // m, 32), (2, b, s // m, 16)]
        jm = groups[shape]["cache"][2]["local"]      # 1 period of 2
        assert jm == [(1, b, 3, 256 // m), (1, b, 256 // m, 16),
                      (1, b, s, 4 // m, 32), (1, b, s, 4 // m, 32)]


@pytest.mark.parametrize("shape,case", CASES)
def test_six_fednl_steps_follow_one_process(shape, case, groups):
    """Every step's MoE routing (jamba) is compared with one process's:
    up to a first flip, which must come at a router near tie
    (``FLIPS``), the losses follow one process within ``LOSS_REL``, and
    after it within ``FLIP_LOSS_REL``."""
    run = groups[shape]["train"][case]
    _, arch, ov, rep = CONFIGS[case]
    want = _one_process_routed(arch, ov, rep, n_silos=shape[0])
    assert run["error"] is None
    flip = _first_flip(run["routes"], want["routes"])
    assert (None if flip is None else flip[0]) == FLIPS.get((shape, case))
    until = STEPS if flip is None else flip[0]
    np.testing.assert_allclose(run["loss"][:until], want["loss"][:until],
                               rtol=LOSS_REL, atol=0)
    assert run["loss"][-1] < run["loss"][0]
    if flip is not None:
        assert float(flip[1].max()) <= NEAR_TIE
        np.testing.assert_allclose(run["loss"], want["loss"],
                                   rtol=FLIP_LOSS_REL, atol=0)


@pytest.mark.parametrize("shape", SHAPES)
def test_every_leaf_whole_over_model_agrees_on_every_model_rank(shape,
                                                                groups):
    """The leaves the rules hold whole over "model" (MLA's ``wdq``,
    ``wdkv``, ``wkrope``; the Mamba mixer's ``conv_b``, ``dt_bias``,
    ``d_skip``, ``wdt``; norms, the MoE router): the same first-step
    gradient (torch.equal) and the same value after six steps on every
    model rank. A gradient that were one rank's part (``copy_in`` on the
    layer's input instead of the down-projections' outputs) would differ
    between the ranks."""
    for run in groups[shape]["train"]:
        assert run["n_replicated"] > 0
        assert run["replicated_grads_equal"]
        assert run["replicated_params_equal"]


@pytest.mark.parametrize("shape,case", CASES)
def test_refresh_on_shards_equals_one_process_bit_for_bit(shape, case,
                                                          groups):
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
    routes = got["routes"]
    if arch == JAMBA:
        # win's 512 columns lie on 128-wide tile bounds at M = 4 (128 a
        # rank) and 2; a_log's 16 state columns never do
        assert routes["params/layers/0/mixer/win"] == "tiles"
        assert routes["params/layers/0/mixer/a_log"] == "gathered"
    else:
        assert routes["params/layers/0/mixer/wuk"] == "gathered"
        assert routes["params/layers/0/mixer/wdq"] == "whole"


@pytest.mark.parametrize("shape,case", [(s, c) for s in [(1, 2), (1, 4)]
                                        for c in range(len(GEN_CASES))])
def test_generate_is_one_process(shape, case, groups):
    """Greedy and sampled tokens over a latent cache split on its
    sequence (S = 12) and a whole one (S = 11), with every head on each
    rank (6 heads at M = 4), and jamba's Mamba caches on Di."""
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


# -- what the axis admits and refuses ----------------------------------------------


@pytest.mark.parametrize("arch", [MINICPM3, JAMBA])
@pytest.mark.parametrize("m", [2, 4, 16])
def test_the_published_configs_are_admitted(arch, m):
    check_model_axis(get_config(arch), {"data": 1, "model": m})


@pytest.mark.parametrize("arch,field,value,m,what", [
    (MINICPM3, "d_ff", 250, 4, "d_ff = 250"),
    (MINICPM3, "n_heads", 5, 64, "heads x v_head_dim = 160"),
    (JAMBA, "d_model", 129, 4, "Di"),
    (JAMBA, "d_ff", 250, 4, "d_ff = 250"),
    ("xlstm-350m", "d_model", 130, 4, "d_model = 130"),
    ("whisper-tiny", "d_ff", 250, 4, "d_ff = 250"),
    ("whisper-tiny", "head_dim", 30, 16, "heads x head_dim = 120"),
    ("llava-next-34b", "kv_heads", 3, 64, "kv_heads x head_dim = 96")])
def test_a_width_that_does_not_split_is_refused(arch, field, value, m, what):
    """A width the rules would replicate although no layer computes it
    whole: MLA's ``wo`` rows and d_ff; the Mamba mixer's Di, and jamba's
    d_ff, which its dense MLP layers split even where its 4 experts do;
    xLSTM's d_model (the mLSTM's columns, both blocks' ``wout`` rows);
    the dense widths of whisper's encoder, decoder and cross-attention and
    of llava."""
    cfg = dataclasses.replace(_cfg(arch, NARROW, None), **{field: value})
    with pytest.raises(NotImplementedError, match=what):
        check_model_axis(cfg, {"data": 1, "model": m})
