"""The mesh's "model" axis for xLSTM (xlstm-350m), the encoder-decoder
(whisper-tiny) and the VLM (llava-next-34b), on gloo groups of spawned
CPU ranks (``tests/_torch_dist.py``; one group a mesh shape: (1, 4) and
(2, 2) on 4 ranks, (1, 2) on 2), at reduced widths:

* xlstm-350m with d_ff 0 (no MLP, as the published config; ``reduced``
  would add one of 512) at d 256: an mLSTM and an sLSTM; its 4 heads
  split at M = 2 and 4, ``wif``'s 8 gate columns too;
* the same with 6 heads at d 192: at M = 4 the heads do not split
  (``wq``'s 192 columns do, 48 a rank), so every rank computes every
  head and its C cache is whole;
* whisper-tiny with 6 heads at d 192 (d_ff 256): M = 2 splits the heads
  of the encoder, the decoder and the cross-attention, M = 4 takes
  ``q_whole``;
* llava-next-34b at d 128 (d_ff 256), 16 patches before the tokens.

The oracles: the reference's own ``tree_param_specs``,
``opt_state_shardings`` and ``cache_specs`` on a ``jax.make_mesh`` of
the same shape over 4 forced host devices (a subprocess); the port
without a mesh in this process (``test_torch_ssm.py``,
``test_torch_encdec.py`` and ``test_torch_ssm_train.py`` hold it to the
reference), with ``n_silos`` = the data extent and the family's frames
or patches from ``add_modality_inputs``, as the train driver draws them.

Tolerances (f32), as ``test_torch_mla_hybrid_axis.py``'s: the logits
within 1e-4 of the largest (T = 600: the mLSTM's chunked scan, the
sLSTM's loop, K9's plain version on the decoder's heads); six fednl
steps, each loss within 1e-5 relative; every leaf held whole over
"model" equal bit for bit on every model rank (the first step's gradient
and the value after the sixth: the sLSTM's ``b``, the norms, whisper's
encoder norms); a refresh handed the same observations bit for bit;
``generate``'s tokens exactly, and every cache leaf held whole (the
mLSTM's n and m, the sLSTM's state, the encoder's memory) the same on
every model rank after the decode.
"""

import numpy as np
import pytest
import torch

from _torch_dist import finish_group, ssm_axis_all, start_group
from _torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)
from repro_torch.configs import get_config
from repro_torch.data.tokens import TokenPipeline
from repro_torch.launch.serve import generate
from repro_torch.launch.sharding import check_model_axis
from repro_torch.launch.steps import make_optimizer, make_train_step
from repro_torch.launch.train import add_modality_inputs
from repro_torch.models import build_model
from repro_torch.second_order.fednl_precond import (FedNLPrecondOptimizer,
                                                    FedNLPrecondState)
from repro_torch.tree import tree_leaves, tree_map
from test_torch_model_axis import (ARGV, BATCH, CACHE, K, LOSS_REL, LR,
                                   REFRESH_K, SEQ, _cfg, _draws,
                                   _finish_reference, _pairs, _placements_of,
                                   _start_reference)

XLSTM, WHISPER, LLAVA = "xlstm-350m", "whisper-tiny", "llava-next-34b"
SIX_HEADS = dict(n_heads=6, kv_heads=6, head_dim=32)
# (name, arch, overrides of .reduced, fields replaced after)
CONFIGS = [("xlstm", XLSTM, dict(d_ff=0), None),
           ("xlstm_6_heads", XLSTM, dict(d_model=192, d_ff=0), SIX_HEADS),
           ("whisper_6_heads", WHISPER, dict(d_model=192, d_ff=256),
            SIX_HEADS),
           ("llava", LLAVA, dict(d_model=128, d_ff=256), None)]
LOGITS = ([(arch, ov, rep) for _, arch, ov, rep in CONFIGS], 1, 600)
# (arch, overrides, replace, batch, prompt_len, gen, greedy, seed): the
# KV cache's S is prompt_len + gen, 12 splits over 2 and 4, 11 over
# neither
GEN_CASES = [(XLSTM, CONFIGS[0][2], None, 2, 5, 7, True, 3),
             (XLSTM, CONFIGS[1][2], SIX_HEADS, 2, 5, 7, False, 3),
             (WHISPER, CONFIGS[2][2], SIX_HEADS, 2, 5, 7, True, 3),
             (WHISPER, CONFIGS[2][2], SIX_HEADS, 2, 5, 6, False, 3),
             (LLAVA, CONFIGS[3][2], None, 2, 5, 7, True, 3)]
# the tool on the (1, 2) group (a VLM's patches before its text, both
# sides) and on the (1, 4) one (whisper's prefill with its frames)
TOOL = {(1, 2): ["--device", "cpu", "--smoke", "--arch", LLAVA, "--data",
                 "1", "--model", "2", "--steps", "2"],
        (1, 4): ["--device", "cpu", "--smoke", "--arch", WHISPER, "--data",
                 "1", "--model", "4", "--serve", "--prompt", "40", "--gen",
                 "4"]}
# the groups take about 45 s on 8 cores beside one other file; the
# suite runs several such files at once
GROUP_SECONDS = 360
SHAPES = [(1, 4), (2, 2)]
CASES = [(shape, c) for shape in SHAPES for c in range(len(CONFIGS))]


def _start(shape, tmp_path_factory):
    train = shape != (1, 2)
    runs = [(arch, ov, rep, ARGV) for _, arch, ov, rep in CONFIGS]
    refresh = [(arch, ov, rep, *_draws(_cfg(arch, ov, rep), shape[0], i),
                REFRESH_K) for i, (_, arch, ov, rep) in enumerate(CONFIGS)]
    cache = [(arch, ov, rep, *CACHE) for _, arch, ov, rep in CONFIGS]
    tool = TOOL.get(shape)
    if tool is not None:
        tool = (tool, str(tmp_path_factory.mktemp("tool")))
    return start_group(
        ssm_axis_all, shape[0] * shape[1],
        tmp_path_factory.mktemp("ssm" + "x".join(map(str, shape))), shape,
        LOGITS, dict(train_runs=runs if train else (),
                     refresh_cases=refresh if train else (),
                     cache_cases=cache, tool=tool),
        GEN_CASES if shape[0] == 1 else (), seconds=GROUP_SECONDS)


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """The three groups and the reference's specs, all started at once:
    (1, 4) and (2, 2) with training and the refresh, (1, 4) and (1, 2)
    with ``generate``, every one with the logits."""
    ref = _start_reference(CONFIGS)
    started = {shape: _start(shape, tmp_path_factory)
               for shape in ((1, 4), (2, 2), (1, 2))}
    out = {shape: finish_group(h) for shape, h in started.items()}
    out["reference"] = _finish_reference(ref)
    return out


def _inputs(cfg, tokens, step: int = 0) -> dict:
    return add_modality_inputs({"tokens": tokens}, cfg, step)


def _one_forward(case):
    _, arch, ov, rep = CONFIGS[case]
    cfg = _cfg(arch, ov, rep)
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0))
    _, batch, t = LOGITS
    tokens = torch.randint(0, cfg.vocab, (batch, t),
                           generator=torch.Generator().manual_seed(1))
    inputs = _inputs(cfg, tokens)
    with torch.no_grad():
        logits, _ = model.forward(params, inputs)
        loss = model.loss_fn(params, {**inputs,
                                      "targets": torch.roll(tokens, -1, 1)})
    return logits, float(loss)


def _one_process(arch, ov, rep, n_silos: int) -> dict:
    """The train driver's six steps without a mesh: its batches (a VLM's text
    ``SEQ`` less its patches long) with their frames or patches."""
    cfg = _cfg(arch, ov, rep)
    model = build_model(cfg, use_remat=True)
    params = model.init_params(torch.Generator().manual_seed(0))
    opt = make_optimizer("fednl", LR, k_per_block=K, curvature="fisher")
    state = opt.init(params)
    step = make_train_step(model, opt, refresh_every=2, n_silos=n_silos)
    text = SEQ - (cfg.vision_tokens if cfg.family == "vlm" else 0)
    pipe = TokenPipeline(vocab_size=cfg.vocab, seq_len=text,
                         global_batch=BATCH, seed=0)
    losses = []
    for i in range(6):
        batch = add_modality_inputs(pipe.batch(i, device="cpu"), cfg, i)
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
    return {"loss": losses}


@pytest.mark.parametrize("shape", [(1, 4), (2, 2), (1, 2)])
@pytest.mark.parametrize("case", range(len(CONFIGS)))
def test_logits_follow_one_process(shape, case, groups):
    """A 600-token prefill (llava: 16 patches + 600 tokens; whisper over
    its 32 frames): the mLSTM on the rank's heads or every head, the
    sLSTM whole on every rank, the encoder, the decoder and the
    cross-attention on the rank's heads."""
    got = groups[shape]["logits"][case]
    want, loss = _one_forward(case)
    top = float(want.abs().max())
    assert got["logits"].shape == want.shape
    assert float((got["logits"] - want).abs().max()) <= 1e-4 * top
    assert abs(got["loss"] - loss) <= 1e-5 * abs(loss)


def _mixer(layout, j: int = 0, stack: str = "layers") -> dict:
    sub = layout[stack]
    return (sub[j] if stack == "layers" else sub)["mixer"]


@pytest.mark.parametrize("shape,case", CASES)
def test_params_state_and_cache_lie_as_the_reference_rules_say(
        shape, case, groups):
    """Leaf by leaf against the reference's specs; then what the layers
    must move: the mLSTM's ``wq``, ``wif`` and ``wo_gate`` on their
    columns, ``wout`` on its rows; the sLSTM's ``wx`` and ``wr`` on
    their columns (gates, not channels), ``b`` whole; whisper's encoder
    and cross-attention on their heads' columns, its norms whole."""
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
    arch = CONFIGS[case][1]
    if arch == XLSTM:
        m, s = _mixer(layout, 0), _mixer(layout, 1)
        assert [m[n][1] for n in ("wq", "wif", "wo_gate", "wout")] == [
            "Shard2", "Shard2", "Shard2", "Shard1"]
        assert [s[n][1] for n in ("wx", "wr", "b", "wout")] == [
            "Shard2", "Shard2", "Replicate", "Shard1"]
    elif arch == WHISPER:
        enc = layout["enc_layers"]
        assert enc["mixer"]["wq"][1] == "Shard2"
        assert enc["norm1"]["b"][1] == "Replicate"
        assert layout["layers"][0]["cross"]["wk"][1] == "Shard2"
        assert layout["layers"][0]["cross"]["wo"][1] == "Shard1"
    else:
        assert _mixer(layout)["wq"][1] == "Shard2"
        assert layout["embed"][1] == "Shard0"


def test_the_caches_take_each_layout(groups):
    """The mLSTM's C over "model" on its heads where H divides (4 heads
    at M = 2 and 4, 6 at M = 2), whole where not (6 at M = 4), its n and
    m whole; the sLSTM's state whole; whisper's KV caches on their 6
    heads at M = 2 and on S = 12 at M = 4, its memory whole."""
    b, s = CACHE
    for shape, m in (((1, 4), 4), ((1, 2), 2)):
        got = groups[shape]["cache"]
        assert got[0]["local"] == [(1, b, 4 // m, 64, 64), (1, b, 4, 64),
                                   (1, b, 4)] + [(1, b, 256)] * 4
        heads = 6 // m if 6 % m == 0 else 6
        assert got[1]["local"][:3] == [(1, b, heads, 32, 32), (1, b, 6, 32),
                                       (1, b, 6)]
        kv = ((2, b, s, 3, 32) if m == 2 else (2, b, s // 4, 6, 32))
        assert got[2]["local"] == [kv, kv, (b, 32, 192)]


@pytest.mark.parametrize("shape,case", CASES)
def test_six_fednl_steps_follow_one_process(shape, case, groups):
    run = groups[shape]["train"][case]
    _, arch, ov, rep = CONFIGS[case]
    want = _one_process(arch, ov, rep, n_silos=shape[0])
    assert run["error"] is None
    np.testing.assert_allclose(run["loss"], want["loss"], rtol=LOSS_REL,
                               atol=0)
    # reduced llava's 16 text tokens a row do not fall in six steps at
    # this lr, with or without a mesh
    assert (run["loss"][-1] < run["loss"][0]) == (
        want["loss"][-1] < want["loss"][0])


@pytest.mark.parametrize("shape", SHAPES)
def test_every_leaf_whole_over_model_agrees_on_every_model_rank(shape,
                                                                groups):
    """The leaves the rules hold whole over "model" (the sLSTM's ``b``,
    the norms, whisper's encoder norms and biases): the same first-step
    gradient (torch.equal) and the same value after six steps on every
    model rank. A gradient that were one rank's part (the memory of the
    cross-attention without ``copy_in``, which gives the encoder one
    rank's heads' share) would differ between the ranks. (``split_on``
    in place of the narrow before ``wout``, which sums the gathered
    weights' gradients M times, shows in the six steps' losses.)"""
    for run in groups[shape]["train"]:
        assert run["n_replicated"] > 0
        assert run["replicated_grads_equal"]
        assert run["replicated_params_equal"]


# per case, (shape, leaf, route) the refresh must take: K1 on the rank's
# model shard where it lies on 128-wide tile bounds ("tiles"), else the
# leaf gathered over "model" first
ROUTES = {0: [((1, 4), "params/layers/1/mixer/wx", "tiles"),
              ((1, 4), "params/layers/0/mixer/wif", "gathered"),
              ((1, 4), "params/layers/1/mixer/b", "whole"),
              ((2, 2), "params/layers/0/mixer/wq", "tiles")],
          1: [((1, 4), "params/layers/0/mixer/wq", "gathered"),
              ((2, 2), "params/layers/1/mixer/wx", "tiles")],
          2: [((1, 4), "params/enc_layers/mixer/wq", "gathered"),
              ((2, 2), "params/layers/0/ffn/wi", "tiles")],
          3: [((1, 4), "params/embed", "tiles")]}


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
    for where, leaf, route in ROUTES[case]:
        if where == shape:
            assert got["routes"][leaf] == route, leaf


@pytest.mark.parametrize("shape,case", [(s, c) for s in [(1, 2), (1, 4)]
                                        for c in range(len(GEN_CASES))])
def test_generate_is_one_process(shape, case, groups):
    """Greedy and sampled tokens, and every cache leaf that each rank
    holds whole equal on every model rank after the decode: the mLSTM's
    n and m, which a rank that steps only its heads gathers (and its C
    where the heads do not split), the sLSTM's state, whisper's memory
    and its KV caches where neither their heads nor S = 11 split (llava's
    4 KV heads split at M = 2 and 4: none of its leaves is whole)."""
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
    tokens = got["tokens"]
    assert tokens.shape == (batch, prompt_len + gen)
    assert torch.equal(tokens, want)
    equal = got["whole_equal"]
    assert all(equal.values())
    if arch == XLSTM:
        assert {"blocks/0/n", "blocks/0/m", "blocks/1/h"} <= set(equal)
        # C is the rank's heads where they split, whole where not
        assert ("blocks/0/c" in equal) == (rep is not None and shape[1] == 4)
    if arch == WHISPER:
        assert "enc" in equal


def test_the_tool_runs_each_new_family(groups):
    """``tools/mesh_train_check.py --smoke``: llava trained on (1, 2)
    against one process (16 patches before its 128 text tokens), whisper
    served on (1, 4) against one process (frames on both sides)."""
    for shape in TOOL:
        rec = groups[shape]["tool"]
        assert rec["code"] == 0 and rec["json"]["ok"], rec
    train = groups[(1, 2)]["tool"]["json"]
    assert train["arch"] == LLAVA and train["loss_rel_max"] <= 1e-2
    serve = groups[(1, 4)]["tool"]["json"]
    assert serve["arch"] == WHISPER and serve["tokens_equal"]


# -- what the axis admits -----------------------------------------------------


@pytest.mark.parametrize("arch", [XLSTM, WHISPER, LLAVA])
@pytest.mark.parametrize("m", [2, 4, 16])
def test_the_published_configs_are_admitted(arch, m):
    """Every width divides; at M = 16 xlstm-350m's ``wif`` (8 columns) and
    whisper's vocab (51,865) do not, and the rules replicate them: the
    mLSTM takes ``wif`` whole, every rank the whole vocab."""
    check_model_axis(get_config(arch), {"data": 1, "model": m})


# -- the rounding-sized change that sets xLSTM's bounds -----------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nudged_moves_each_weight_by_about_one_rounding(dtype):
    """``tree.nudged``: every floating leaf times 1 + u z (u the type's
    unit roundoff, z ~ N(0, 1)), in its own type and shape; integer leaves
    as they were; the same draws from the same seed."""
    from repro_torch.tree import nudged

    g = torch.Generator().manual_seed(0)
    tree = {"w": [torch.randn((64, 64), generator=g).to(dtype)],
            "ids": torch.arange(10)}
    a = nudged(tree, torch.Generator().manual_seed(1))
    b = nudged(tree, torch.Generator().manual_seed(1))
    assert torch.equal(a["ids"], tree["ids"])
    w, moved = tree["w"][0], a["w"][0]
    assert moved.dtype == dtype and moved.shape == w.shape
    assert torch.equal(moved, b["w"][0])
    rel = ((moved.float() - w.float()).abs() / w.float().abs()).max()
    u = torch.finfo(dtype).eps / 2
    # |z| < 6 over 4,096 draws, and the product rounds once more
    assert 0 < float(rel) <= 6 * u + 2 * u
