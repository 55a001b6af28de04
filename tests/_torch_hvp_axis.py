"""Shared pieces of the port's tests of Hutchinson curvature over the
mesh's "model" axis (``tests/test_torch_hvp_axis*.py``): one gloo group
a mesh shape, (1, 2), (1, 4) and (2, 2), each running the train driver
with ``--hvp`` on every config of a file (``_torch_dist.hvp_axis_train``),
and the same steps on one process in this process, with ``n_silos`` =
the data extent (the one-process Hz is held to the reference by
``test_torch_hvp_reference*.py`` and ``test_torch_train.py``).

The checks, per config and mesh shape:

* z: each rank's probe of each leaf is its block of one process's z of
  the same silo, bit for bit (a leaf held whole: one process's z on
  every model rank);
* Hz: each leaf, its ranks' shards joined on its "model" dim, within
  ``HZ_REL`` of its largest |value| of one process's (f32: the
  row-parallel partial products are summed over the ranks where one
  process takes one product; measured at most 5e-6), and every leaf held
  whole over "model" with the same Hz on every model rank, bit for bit;
* the refresh: H and l after the first step equal one process's
  ``refresh`` of the mesh's own observations z * Hz, bit for bit;
* four fednl steps (a refresh on steps 0 and 2): each loss within
  ``LOSS_REL`` relative of one process's (measured at most 2e-7), each
  param leaf as ``test_torch_model_axis.py`` holds six Fisher steps.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from _torch_dist import finish_group, start_group, hvp_axis_train
from repro_torch.configs import get_config
from repro_torch.data.tokens import TokenPipeline
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.train import add_modality_inputs
from repro_torch.models import build_model
from repro_torch.second_order.fednl_precond import (FedNLPrecondOptimizer,
                                                    FedNLPrecondState)
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

STEPS, BATCH, SEQ, LR, K = 4, 8, 32, 2e-3, 2048
ARGV = ["--steps", str(STEPS), "--batch", str(BATCH), "--seq", str(SEQ),
        "--optimizer", "fednl", "--refresh-every", "2", "--lr", str(LR),
        "--curvature-k", str(K), "--device", "cpu", "--hvp"]
SHAPES = [(1, 2), (1, 4), (2, 2)]
HZ_REL, LOSS_REL = 1e-4, 1e-5
PARAM_REL, PARAM_OUTLIERS, PARAM_MISS = 1e-4, 1e-3, 5e-2
# the groups take about 30 s on 8 idle cores for every family at once;
# the suite runs several such files at once
GROUP_SECONDS = 480


def start(tmp_path_factory, configs, prefix: str, tools=None) -> dict:
    """One group a mesh shape, all started (``start_group``): the train
    driver with ``--hvp`` on each (name, arch, overrides, replace) of
    ``configs``, then ``tools[shape]``'s argv of
    ``tools/mesh_train_check.py`` where given."""
    runs = [(arch, ov, rep, ARGV) for _, arch, ov, rep in configs]
    out = {}
    for shape in SHAPES:
        tool = (tools or {}).get(shape)
        if tool is not None:
            tool = (tool, str(tmp_path_factory.mktemp(prefix + "_tool")))
        out[shape] = start_group(
            hvp_axis_train, shape[0] * shape[1],
            tmp_path_factory.mktemp(prefix + "x".join(map(str, shape))),
            shape, runs, tool, seconds=GROUP_SECONDS)
    return out


def finish(started: dict, configs) -> dict:
    """The groups' results, once this process has run ``one_process`` of
    each config for each data extent meanwhile (on one thread)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for config in configs:
            for data in sorted({shape[0] for shape in SHAPES}):
                one_process(config, data)
    finally:
        torch.set_num_threads(threads)
    return {shape: finish_group(h) for shape, h in started.items()}


def _config(arch, overrides, replace):
    cfg = get_config(arch).reduced(**dict(overrides))
    return dataclasses.replace(cfg, **dict(replace or ()))


def _key(config) -> tuple:
    _, arch, ov, rep = config
    return (arch, tuple(sorted(ov.items())),
            None if rep is None else tuple(sorted(rep.items())))


def one_process(config, n_silos: int) -> dict:
    """The driver's steps without a mesh (``_one_process``, cached)."""
    return _one_process(_key(config), n_silos)


@functools.lru_cache(maxsize=None)
def _one_process(key, n_silos: int) -> dict:
    """The train driver's ``STEPS`` hvp steps on one process: its batches
    (a VLM's text ``SEQ`` less its patches long, the family's frames or
    patches), ``n_silos`` silos: each step's loss, the first refresh's z
    and Hz of each silo (leaves), H and l after the first step, and the
    final params."""
    cfg = _config(*key)
    model = build_model(cfg, use_remat=True)
    params = model.init_params(torch.Generator().manual_seed(0))
    opt = steps_mod.make_optimizer("fednl", LR, k_per_block=K,
                                   curvature="hutchinson")
    state = opt.init(params)
    silos, hvp = [], steps_mod.grad_and_hvp

    def recording(model, p, batch, z):
        g, hz = hvp(model, p, batch, z)
        silos.append((tree_leaves(z), tree_leaves(hz)))
        return g, hz

    text = SEQ - (cfg.vision_tokens if cfg.family == "vlm" else 0)
    pipe = TokenPipeline(vocab_size=cfg.vocab, seq_len=text,
                         global_batch=BATCH, seed=0)
    out = {"loss": []}
    steps_mod.grad_and_hvp = recording
    try:
        step = steps_mod.make_train_step(model, opt, refresh_every=2,
                                         n_silos=n_silos, hvp=True)
        for i in range(STEPS):
            batch = add_modality_inputs(pipe.batch(i, device="cpu"), cfg, i)
            params, state, m = step(params, state, batch)
            out["loss"].append(float(m["loss"]))
            if i == 0:
                out["h1"], out["l1"] = state.h, state.l
    finally:
        steps_mod.grad_and_hvp = hvp
    out["silos"], out["params"] = silos[:n_silos], params
    return out


def _joined(stack: torch.Tensor, d: int, mdim):
    """Data rank ``d``'s tensor whole over "model" from a
    ``_rank_stack`` (data, model, ...): its model ranks' shards joined on
    ``mdim``, or model rank 0's where the leaf is held whole."""
    return stack[d][0] if mdim is None else torch.cat(list(stack[d]), mdim)


def check_z(run: dict, want: dict, shape) -> None:
    for j, mdim in enumerate(run["mdims"]):
        for d in range(shape[0]):
            z = want["silos"][d][0][j]
            if mdim is None:
                assert all(torch.equal(x, z) for x in run["z"][j][d]), j
            else:
                size = z.shape[mdim] // shape[1]
                assert all(torch.equal(x, z.narrow(mdim, m * size, size))
                           for m, x in enumerate(run["z"][j][d])), j


def check_hz(run: dict, want: dict, shape) -> None:
    assert run["whole_hz_equal"]
    for j, mdim in enumerate(run["mdims"]):
        for d in range(shape[0]):
            ref = want["silos"][d][1][j]
            got = _joined(run["hz"][j], d, mdim)
            scale = float(ref.abs().max())
            assert scale > 0 and got.shape == ref.shape
            assert float((got - ref).abs().max()) <= HZ_REL * scale, (
                j, float((got - ref).abs().max()), scale)


def check_refresh(run: dict, shape) -> None:
    """H and l after the mesh's first step against one process's refresh
    of the mesh's observations (every silo's z * Hz whole, stacked)."""
    obs = [torch.stack([_joined(stack, d, mdim) for d in range(shape[0])])
           for stack, mdim in zip(run["obs"], run["mdims"])]
    h = run["h1"]
    opt = FedNLPrecondOptimizer(k_per_block=K, curvature="hutchinson")
    state = FedNLPrecondState(0, tree_map(torch.zeros_like, h), None, None)
    want = opt.refresh(state, tree_unflatten(h, obs))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(h),
                                                 tree_leaves(want.h)))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(run["l1"]),
                                                 tree_leaves(want.l)))


def check_steps(run: dict, want: dict) -> None:
    assert run["error"] is None
    assert len(run["loss"]) == STEPS
    rel = max(abs(a - b) / abs(b) for a, b in zip(run["loss"], want["loss"]))
    assert rel <= LOSS_REL, rel
    for got, ref in zip(tree_leaves(run["params"]),
                        tree_leaves(want["params"])):
        scale = float(ref.abs().max()) or 1.0
        gap = (got - ref).abs()
        assert float((gap > PARAM_REL * scale).float().mean()) <= PARAM_OUTLIERS
        assert float(gap.max()) <= PARAM_MISS * scale
