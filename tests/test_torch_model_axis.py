"""The mesh's "model" axis for the dense family (tensor parallelism by
the reference's sharding rules) on gloo groups of spawned CPU ranks
(``tests/_torch_dist.py``; one group a mesh shape: (1, 4) and (2, 2) on
4 ranks, (1, 2) on 2), at reduced widths: qwen2 (4 heads over 2 KV
heads: at M = 4 only the KV heads fail to split), starcoder2-15b (4 over
4) and qwen2 with its published 14 heads over 2 (hd 16, d 224: the heads
do not split at M = 4, the degraded case).

The oracles: the reference's own ``tree_param_specs``,
``opt_state_shardings`` and ``cache_specs`` on a ``jax.make_mesh`` of
the same shape over 4 forced host devices (a subprocess); the port
without a mesh in this process (``test_torch_train.py`` holds it to the
reference's jitted step), with ``n_silos`` = the data extent.

Tolerances (f32):
* six fednl steps: each loss within 1e-5 relative of one process's, and
  each param leaf within 1e-4 of its largest |value| at all but 0.1 % of
  its entries, and within 5e-2 of it at every entry. The row-parallel partial products are summed over the
  ranks in f32 where one process takes one product (measured loss gaps
  about 1e-7 relative); a refresh then may pick the other of two
  near-tied Block-Top-K entries, and the preconditioned step at such an
  entry moves with its H: measured, at most 8.4e-5 of a leaf's entries
  past the bound, by up to 3.3e-2 of its max (reduced starcoder2-15b at
  (1, 4); AdamW's sign of a near-zero gradient does the same, 2e-3 of the
  entries of a bias);
* a refresh handed the same observations: H and l bit for bit;
* vocab-parallel cross-entropy and its gradient within 1e-6 of
  ``cross_entropy``'s; the distributed argmax exactly, ties to the lower
  index; ``generate``'s greedy and sampled tokens exactly.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from _torch_dist import (finish_group, model_axis_all, one_rank_group,
                         start_group)
from _torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)
from repro_torch.configs import get_config, model_param_shapes
from repro_torch.data.tokens import TokenPipeline
from repro_torch.launch.serve import generate
from repro_torch.launch.steps import make_optimizer, make_train_step
from repro_torch.launch.train import train
from repro_torch.models import build_model
from repro_torch.models.common import cross_entropy
from repro_torch.second_order.fednl_precond import (FedNLPrecondOptimizer,
                                                    FedNLPrecondState)
from repro_torch.tree import tree_leaves, tree_map

QWEN, SC15 = "qwen2-0.5b", "starcoder2-15b"
DEGRADED = dict(n_heads=14, kv_heads=2, head_dim=16)
# (name, arch, overrides of .reduced, fields replaced after)
CONFIGS = [("qwen2", QWEN, {}, None), ("starcoder2_15b", SC15, {}, None),
           ("qwen2_14_heads", QWEN, {"d_model": 224}, DEGRADED)]
# the train CLI's default k in training; a sparser k for the refresh's
# bitwise check
STEPS, BATCH, SEQ, LR, K, REFRESH_K = 6, 8, 32, 2e-3, 2048, 64
ARGV = ["--steps", str(STEPS), "--batch", str(BATCH), "--seq", str(SEQ),
        "--optimizer", "fednl", "--refresh-every", "2", "--lr", str(LR),
        "--curvature-k", str(K), "--device", "cpu"]
LOSS_REL, PARAM_REL, PARAM_OUTLIERS, PARAM_MISS = 1e-5, 1e-4, 1e-3, 5e-2
CACHE = (2, 12)            # batch, max_len: S divides by 2 and 4


def _cfg(arch, overrides, replace):
    cfg = get_config(arch).reduced(**overrides)
    return dataclasses.replace(cfg, **(replace or {}))


def _draws(cfg, n: int, seed: int):
    """A nonnegative H and n silos' observations, numpy trees."""
    rng = np.random.default_rng(seed)
    shapes = model_param_shapes(cfg)
    h = tree_map(lambda s: np.abs(rng.standard_normal(s.shape))
                 .astype(np.float32), shapes)
    obs = tree_map(lambda s: np.abs(rng.standard_normal((n,) + s.shape))
                   .astype(np.float32), shapes)
    return h, obs


def _start(shape, tmp_path_factory, configs, gen=False, ops=None,
           tool=None):
    """One group a mesh shape, started (``_torch_dist.start_group``):
    training and a refresh of each of ``configs``, the cache layouts of
    every config, and what ``gen``, ``ops`` and ``tool`` ask."""
    runs = [(arch, ov, rep, ARGV) for _, arch, ov, rep in configs]
    refresh = [(arch, ov, rep, *_draws(_cfg(arch, ov, rep), shape[0], i),
                REFRESH_K) for i, (_, arch, ov, rep) in enumerate(configs)]
    cache = [(arch, ov, rep, *CACHE) for _, arch, ov, rep in CONFIGS]
    if tool is not None:
        tool = (tool, str(tmp_path_factory.mktemp("tool")))
    return start_group(model_axis_all, shape[0] * shape[1],
                       tmp_path_factory.mktemp("x".join(map(str, shape))),
                       shape, runs, refresh, GEN_CASES if gen else (), ops,
                       cache, tool)


# (arch, overrides, replace, batch, prompt_len, gen, greedy, seed): the
# cache's S is prompt_len + gen; 12 splits over 2 and 4, 11 over neither
GEN_CASES = [(QWEN, {}, None, 2, 5, 7, True, 3),
             (SC15, {}, None, 2, 5, 7, True, 3),
             (QWEN, {}, None, 2, 5, 6, True, 3),
             (QWEN, {"d_model": 224}, DEGRADED, 2, 5, 7, False, 3)]


def _ops_inputs():
    rng = np.random.default_rng(7)
    logits = rng.standard_normal((2, 5, 512)).astype(np.float32) * 3
    targets = rng.integers(0, 512, (2, 5))
    ties = rng.standard_normal((3, 512)).astype(np.float32)
    ties[0, [3, 7, 300, 450]] = 9.0       # within rank 0 and across ranks
    ties[1, [200, 300]] = 9.0             # only across ranks (1 and 2)
    ties[2, [511, 130]] = 9.0             # the lower index on the later rank
    return logits, targets, ties


TOOL_ARGV = ["--device", "cpu", "--smoke", "--data", "1", "--model", "4",
             "--steps", "2"]


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """The three groups and the reference's specs, all started at once:
    (1, 4) with every config, the ops, ``generate`` and the tool; (2, 2)
    with reduced qwen2 and starcoder2-15b (the 14-head case is the
    (1, 4) one the heads do not split over); (1, 2) with ``generate``."""
    ref = _start_reference()
    started = {(1, 4): _start((1, 4), tmp_path_factory, CONFIGS, gen=True,
                              ops=_ops_inputs(), tool=TOOL_ARGV),
               (2, 2): _start((2, 2), tmp_path_factory, CONFIGS[:2]),
               (1, 2): _start((1, 2), tmp_path_factory, [], gen=True)}
    out = {shape: finish_group(h) for shape, h in started.items()}
    out["reference"] = _finish_reference(ref)
    return out


@pytest.fixture(scope="module")
def g14(groups):
    return groups[(1, 4)]


@pytest.fixture(scope="module")
def g22(groups):
    return groups[(2, 2)]


@pytest.fixture(scope="module")
def g12(groups):
    return groups[(1, 2)]


@pytest.fixture(scope="module")
def reference_specs(groups):
    return groups["reference"]


def _one_process(arch, overrides, replace, n_silos: int):
    cfg = _cfg(arch, overrides, replace)
    model = build_model(cfg, use_remat=True)
    params = model.init_params(torch.Generator().manual_seed(0))
    opt = make_optimizer("fednl", LR, k_per_block=K, curvature="fisher")
    state = opt.init(params)
    step = make_train_step(model, opt, refresh_every=2, n_silos=n_silos)
    pipe = TokenPipeline(vocab_size=cfg.vocab, seq_len=SEQ,
                         global_batch=BATCH, seed=0)
    out = {"loss": [], "gnorm": []}
    for i in range(STEPS):
        params, state, m = step(params, state, pipe.batch(i, device="cpu"))
        out["loss"].append(float(m["loss"]))
        out["gnorm"].append(float(m["grad_norm"]))
    out["params"] = params
    return out


# -- the layout against the reference's rules ---------------------------------------

_REFERENCE_SPECS = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses, json
    import jax
    from repro.configs import get_config
    from repro.launch import sharding as S
    from repro.launch.steps import make_optimizer
    from repro.models import build_model

    cases, (batch, max_len) = json.loads(sys.argv[1])
    spec = lambda t: jax.tree.map(lambda s: list(s.spec), t)
    is_spec = lambda x: isinstance(x, list) and all(
        e is None or isinstance(e, str) or (isinstance(e, list) and all(
            isinstance(y, str) for y in e)) for e in x)
    out = {}
    for name, arch, ov, rep in cases:
        cfg = dataclasses.replace(get_config(arch).reduced(**ov),
                                  **(rep or {}))
        model = build_model(cfg)
        params = jax.eval_shape(model.init_params, jax.random.PRNGKey(0))
        cache = jax.eval_shape(lambda: model.init_cache(batch, max_len))
        for shape in ((2, 2), (1, 4)):
            mesh = jax.make_mesh(shape, ("data", "model"))
            opt = make_optimizer("fednl", 1e-3)
            st = S.opt_state_shardings(jax.eval_shape(opt.init, params),
                                       params, mesh, cfg)
            out[f"{name}@{shape[0]}x{shape[1]}"] = {
                "params": spec(S.tree_param_specs(params, mesh, cfg)),
                **{f: spec(getattr(st, f)) for f in ("h", "mu", "l")},
                "cache": jax.tree.leaves(spec(S.cache_specs(cache, mesh, cfg)),
                                         is_leaf=is_spec)}
    print("SPECS=" + json.dumps(out))
""")


def _start_reference(configs=None):
    """The reference's specs script in a subprocess, started, for
    ``configs`` ((name, arch, overrides, replace) each; ``CONFIGS`` by
    default)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    return subprocess.Popen([sys.executable, "-c", _REFERENCE_SPECS,
                             json.dumps([configs or CONFIGS, CACHE])],
                            env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _finish_reference(proc) -> dict:
    try:
        stdout, stderr = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    line = [x for x in stdout.splitlines() if x.startswith("SPECS=")]
    assert line, stdout + stderr
    return json.loads(line[0][len("SPECS="):])


def _placements_of(spec: list, shape) -> list:
    """A reference spec's placements on a ("data", "model") mesh of
    ``shape``: Shard(dim) on each axis of extent > 1 that a dim names."""
    out = []
    for axis, extent in zip(("data", "model"), shape):
        p = "Replicate"
        for dim, entry in enumerate(spec):
            names = entry if isinstance(entry, list) else [entry]
            if axis in names and extent > 1:
                p = f"Shard{dim}"
        out.append(p)
    return out


def _pairs(got, want):
    if isinstance(got, dict):
        assert sorted(got) == sorted(want)
        return [p for k in got for p in _pairs(got[k], want[k])]
    if isinstance(got, list) and got and not isinstance(got[0], str):
        assert len(got) == len(want)
        return [p for g, w in zip(got, want) for p in _pairs(g, w)]
    return [(got, want)]


# every config at (1, 4); reduced qwen2 and starcoder2-15b at (2, 2)
CASES = [((1, 4), c) for c in range(len(CONFIGS))] + [((2, 2), 0), ((2, 2), 1)]


@pytest.mark.parametrize("shape,case", CASES)
def test_params_state_and_cache_lie_as_the_reference_rules_say(
        shape, case, g14, g22, reference_specs):
    rec = (g14 if shape == (1, 4) else g22)
    want = reference_specs[f"{CONFIGS[case][0]}@{shape[0]}x{shape[1]}"]
    run = rec["train"][case]
    model_split = 0
    for field in ("params", "h", "mu", "l"):
        got = run["params_layout"] if field == "params" else \
            run["state_layout"][field]
        for g, w in _pairs(got, want[field]):
            assert g == _placements_of(w, shape), (field, g, w)
            model_split += g[1] != "Replicate"
    assert model_split > 0
    cache = rec["cache"][case]["placements"]
    assert cache == [_placements_of(w, shape) for w in want["cache"]]


def test_the_cache_takes_each_layout(g14, g12):
    """KV heads over "model" where KV divides (qwen2 at M = 2, the 4 KV
    heads of reduced starcoder2-15b at 4), else the sequence (qwen2 at
    M = 4)."""
    seg, (b, s), hd = 2, CACHE, 64
    assert g12["cache"][0]["local"][0] == (seg, b, s, 1, hd)
    assert g14["cache"][1]["local"][0] == (seg, b, s, 1, hd)
    assert g14["cache"][0]["local"][0] == (seg, b, s // 4, 2, hd)


# -- training against one process ------------------------------------------------------


@pytest.mark.parametrize("shape,case", CASES)
def test_six_fednl_steps_follow_one_process(shape, case, g14, g22):
    run = (g14 if shape == (1, 4) else g22)["train"][case]
    _, arch, ov, rep = CONFIGS[case]
    want = _one_process(arch, ov, rep, n_silos=shape[0])
    assert run["error"] is None
    np.testing.assert_allclose(run["loss"], want["loss"], rtol=LOSS_REL,
                               atol=0)
    assert run["loss"][-1] < run["loss"][0]
    for got, ref in zip(tree_leaves(run["params"]),
                        tree_leaves(want["params"])):
        scale = float(ref.abs().max()) or 1.0
        gap = (got - ref).abs()
        assert float((gap > PARAM_REL * scale).float().mean()) <= PARAM_OUTLIERS
        assert float(gap.max()) <= PARAM_MISS * scale


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_leaves_whole_over_model_agree_on_every_model_rank(shape, g14, g22):
    """Norm scales and biases held whole over "model": the same gradient
    (torch.equal) and the same value after six steps on every model
    rank."""
    for run in (g14 if shape == (1, 4) else g22)["train"]:
        assert run["n_replicated"] > 0
        assert run["replicated_grads_equal"]
        assert run["replicated_params_equal"]


# -- the refresh ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,case", CASES)
def test_refresh_equals_one_process_bit_for_bit(shape, case, g14, g22):
    got = (g14 if shape == (1, 4) else g22)["refresh"][case]
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


def test_refresh_routes(g14, g22):
    """Which leaves run K1 on the rank's model shard ("tiles") and which
    are gathered whole over "model" first: reduced starcoder2-15b at
    (2, 2) splits every weight on 128-wide tile bounds; at (1, 4) its
    attention columns (64 a rank) are not, its ffn and embedding are."""
    sc22 = g22["refresh"][1]["routes"]
    assert set(sc22.values()) == {"tiles", "whole"}
    sc14 = g14["refresh"][1]["routes"]
    assert sc14["params/layers/0/mixer/wq"] == "gathered"
    assert sc14["params/layers/0/ffn/wi"] == "tiles"
    assert sc14["params/embed"] == "tiles"
    assert sc14["params/layers/0/norm1/w"] == "whole"


# -- losses, tokens and serving ---------------------------------------------------------


def test_vocab_parallel_cross_entropy_and_argmax(g14):
    logits, targets, ties = _ops_inputs()
    x = torch.from_numpy(logits).requires_grad_(True)
    loss = cross_entropy(x, torch.from_numpy(targets))
    grad, = torch.autograd.grad(loss, x)
    got = g14["ops"]
    assert abs(float(got["loss"]) - float(loss.detach())) <= 1e-6 * abs(
        float(loss.detach()))
    assert float((got["grad"] - grad).abs().max()) <= 1e-6
    assert got["argmax"].tolist() == [3, 200, 130]
    assert got["argmax"].tolist() == np.argmax(ties, axis=-1).tolist()


@pytest.mark.parametrize("shape", [(1, 2), (1, 4)])
@pytest.mark.parametrize("case", range(len(GEN_CASES)))
def test_generate_is_one_process(shape, case, g12, g14):
    """Both cache layouts (heads at M = 2 and for starcoder2-15b, the
    sequence for qwen2 at M = 4 with S = 12, whole with S = 11), and the
    14-head qwen2 sampled."""
    import repro_torch.launch.serve as serve_mod

    got = (g12 if shape == (1, 2) else g14)["generate"][case]
    arch, ov, rep, batch, prompt_len, gen, greedy, seed = GEN_CASES[case]
    get = serve_mod.get_config
    serve_mod.get_config = lambda a, smoke=True: _cfg(arch, ov, rep)
    try:
        want = generate(arch, smoke=True, batch=batch, prompt_len=prompt_len,
                        gen=gen, seed=seed, greedy=greedy, device="cpu")
    finally:
        serve_mod.get_config = get
    assert got.shape == (batch, prompt_len + gen) and torch.equal(got, want)


def test_the_mesh_check_tool_runs_on_four_ranks(g14):
    """``tools/mesh_train_check.py --device cpu --smoke --data 1 --model
    4``: the driver over the mesh against one process, losses within the
    tool's ``LOSS_REL``."""
    rec = g14["tool"]
    out = rec["json"]
    assert rec["code"] == 0 and out["ok"]
    assert out["mesh"] == {"data": 1, "model": 4}
    assert out["losses_finite"] and out["loss_rel_max"] <= 1e-2
    assert out["local_bytes"] < out["whole_bytes"] / 2


# -- one-rank model axes ---------------------------------------------------


def test_a_model_axis_of_one_rank_installs_nothing(g12, g14):
    """On the same ranks as a (W, 1) mesh there is no model axis and every
    activation hint is the identity, so the step is the data-axis
    step (held by ``test_torch_sharded_train.py``)."""
    for rec in (g12, g14):
        assert rec["flat_model_axis"] is None
        assert rec["flat_carry_is_identity"]


def test_a_one_by_one_mesh_is_the_step_without_a_mesh():
    from repro_torch.launch.mesh import make_host_mesh

    cfg = _cfg(QWEN, {}, None)
    import repro_torch.launch.train as train_mod

    get = train_mod.get_config
    train_mod.get_config = lambda a, smoke=True: cfg
    try:
        with one_rank_group():
            hist = train(QWEN, steps=STEPS, batch=BATCH, seq=SEQ, lr=LR,
                         optimizer="fednl", refresh_every=2, curvature_k=K,
                         device="cpu",
                         mesh=make_host_mesh(1, 1, device="cpu"))
    finally:
        train_mod.get_config = get
    assert hist == _one_process(QWEN, {}, None, 1)["loss"]
