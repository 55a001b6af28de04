"""The train driver and the serving loop over several ranks (gloo groups
of 4 and 2 spawned CPU processes, ``tests/_torch_dist.py``): params and
the optimizer state laid out by the sharding rules, each rank one FedNL
silo whose K1 payload crosses the ranks before K4.

The oracles: the reference's own spec functions (its multi-device train
and serve drivers fail on jax 0.9.0), computed on 4 and 2 forced host
devices in a subprocess; and the port's step without a mesh, one
process with ``n_silos`` = W, which ``test_torch_train.py`` holds to the
reference's jitted step.

Tolerances: the first refresh's H and l bit for bit (every rank's K1 on
its own silo, the payloads stacked in silo order, K4 and the ridge's
reduction on the same stack as one process's). Loss and grad_norm over
six steps within 1e-5 of each value (f32): the gradient is the mean of
W per-rank means where one process takes one mean over the batch, a
different summation order (~1e-7 relative a step, measured gaps 1.6e-7
for the loss and 8.8e-7 for grad_norm after six fednl steps), and each
later refresh may take the other of two near-tied Block-Top-K entries,
which moves H in a few places. One rank against the step without a mesh,
and greedy tokens on 2 ranks against one: exact.
"""

import functools
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from _torch_dist import (
    driver_run,
    driver_runs,
    generate_run,
    one_rank_group,
    run_group,
)
from _torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)
from repro_torch.configs import get_config
from repro_torch.data.tokens import TokenPipeline
from repro_torch.launch.serve import generate
from repro_torch.launch.steps import make_optimizer, make_train_step
from repro_torch.launch.train import add_modality_inputs
from repro_torch.models import build_model
from repro_torch.tree import tree_leaves

QWEN, GRANITE = "qwen2-0.5b", "granite-moe-1b-a400m"
# the reduced configs: qwen2 as the driver's --smoke one; granite
# narrower (K1's plain version bisects every expert tile on the CPU)
OVERRIDES = {QWEN: {}, GRANITE: dict(d_model=128, d_ff=256, vocab=256)}
STEPS, BATCH, SEQ, LR = 6, 8, 32, 2e-3
REL = 1e-5


def argv(optimizer: str, steps: int = STEPS, batch: int = BATCH) -> list:
    return ["--steps", str(steps), "--batch", str(batch), "--seq", str(SEQ),
            "--optimizer", optimizer, "--refresh-every", "2", "--lr",
            str(LR), "--device", "cpu"]


@pytest.fixture(scope="module")
def qwen4(tmp_path_factory):
    """Rank 0's records of six fednl steps, six AdamW steps, a batch of 6
    and 4 microbatches of a rank's 2 rows, on 4 ranks."""
    return run_group(driver_runs, 4, tmp_path_factory.mktemp("qwen4"), QWEN,
                     OVERRIDES[QWEN], [argv("fednl"), argv("adamw"),
                                       argv("fednl", batch=6),
                                       argv("adamw") + ["--microbatches", "4"]])


@pytest.fixture(scope="module")
def granite4(tmp_path_factory):
    """Two fednl steps of the narrow granite on 4 ranks (64 tokens a
    rank: one routing group of 64, as a quarter of one process's)."""
    return run_group(driver_run, 4, tmp_path_factory.mktemp("granite4"),
                     GRANITE, OVERRIDES[GRANITE], argv("fednl", steps=2))


@functools.lru_cache(maxsize=None)
def one_process(arch: str, optimizer: str, n_silos: int, steps: int = STEPS):
    """The driver's run without a mesh: the same params, batches and
    optimizer in one process, ``n_silos`` silos. Every step's (loss,
    grad_norm), the first step's H and l, the final params."""
    cfg = get_config(arch).reduced(**OVERRIDES[arch])
    model = build_model(cfg, use_remat=True)
    params = model.init_params(torch.Generator().manual_seed(0))
    kw = dict(k_per_block=2048, curvature="fisher") if optimizer == "fednl" \
        else {}
    opt = make_optimizer(optimizer, LR, **kw)
    state = opt.init(params)
    step = make_train_step(model, opt, refresh_every=2, n_silos=n_silos)
    pipe = TokenPipeline(vocab_size=cfg.vocab, seq_len=SEQ, global_batch=BATCH,
                         seed=0)
    out = {"loss": [], "gnorm": []}
    for i in range(steps):
        b = add_modality_inputs(pipe.batch(i, device="cpu"), cfg, i)
        params, state, m = step(params, state, b)
        out["loss"].append(float(m["loss"]))
        out["gnorm"].append(float(m["grad_norm"]))
        if i == 0 and optimizer == "fednl":
            out["h1"], out["l1"] = state.h, state.l
    out["params"] = params
    return out


def _bitwise(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def _close(got: list, want: list) -> None:
    np.testing.assert_allclose(got, want, rtol=REL, atol=0)


# -- the layout against the reference's rules -------------------------------------

_REFERENCE_SPECS = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import json
    import jax
    from repro.configs import get_config
    from repro.launch import sharding as S
    from repro.launch.steps import make_optimizer
    from repro.models import build_model

    overrides = json.loads(sys.argv[1])
    spec = lambda t: jax.tree.map(lambda s: list(s.spec), t)
    out = {}
    for arch, kw in overrides.items():
        cfg = get_config(arch).reduced(**kw)
        params = jax.eval_shape(build_model(cfg).init_params,
                                jax.random.PRNGKey(0))
        mesh = jax.make_mesh((4, 1), ("data", "model"))
        opt = make_optimizer("fednl", 1e-3)
        st = S.opt_state_shardings(jax.eval_shape(opt.init, params), params,
                                   mesh, cfg)
        out[arch] = {"params": spec(S.tree_param_specs(params, mesh, cfg)),
                     **{f: spec(getattr(st, f)) for f in st._fields}}
    print("SPECS=" + json.dumps(out))
""")


@pytest.fixture(scope="module")
def reference_specs():
    """The reference's ``tree_param_specs`` and fednl
    ``opt_state_shardings`` of the reduced configs on a (4, 1) mesh of
    forced host devices, as lists."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", _REFERENCE_SPECS,
                          json.dumps(OVERRIDES)], env=env,
                         capture_output=True, text=True, timeout=300)
    line = [x for x in out.stdout.splitlines() if x.startswith("SPECS=")]
    assert line, out.stdout + out.stderr
    return json.loads(line[0][len("SPECS="):])


def _placements_of(spec: list) -> list:
    """A reference spec's placements on the ("data" 4, "model" 1) mesh, as
    the ranks report them: Shard(dim) on "data" where a dim names it."""
    data = "Replicate"
    for dim, entry in enumerate(spec):
        names = entry if isinstance(entry, list) else [entry]
        if "data" in names:
            data = f"Shard{dim}"
    return [data, "Replicate"]


def _pairs(got, want):
    """(got leaf, want leaf) over the port's tree (dicts in insertion
    order) and the reference's JSON tree."""
    if isinstance(got, dict):
        assert sorted(got) == sorted(want)
        return [p for k in got for p in _pairs(got[k], want[k])]
    if isinstance(got, list) and got and not isinstance(got[0], str):
        assert len(got) == len(want)
        return [p for g, w in zip(got, want) for p in _pairs(g, w)]
    return [(got, want)]


@pytest.mark.parametrize("arch", [QWEN, GRANITE])
def test_params_and_state_lie_as_the_reference_rules_say(arch, qwen4,
                                                         granite4,
                                                         reference_specs):
    rec = qwen4[0] if arch == QWEN else granite4
    want = reference_specs[arch]
    shards = 0
    for field in ("params", "h", "mu", "l"):
        got = rec["params_layout"] if field == "params" else \
            rec["state_layout"][field]
        for g, w in _pairs(got, want[field]):
            assert g == _placements_of(w), (field, g, w)
            shards += g[0] != "Replicate"
    assert shards > 0
    assert want["step"] == [] and rec["state_layout"]["step"] == "int"
    assert all(g == ["Replicate", "Replicate"]
               for g, _ in _pairs(rec["state_layout"]["l"], want["l"]))


def test_a_rank_holds_a_quarter_plus_the_replicated_leaves(qwen4):
    for rec in qwen4[:2]:
        assert rec["local_bytes"] <= (rec["whole_bytes"] / 4
                                      + rec["replicated_bytes"])
        assert rec["local_bytes"] < rec["whole_bytes"] / 2
        assert rec["batch_rows"] == BATCH // 4


def test_the_forward_gathers_one_layer_at_a_time(qwen4):
    """Every tensor the installed hook gathered in the first step is a
    leaf outside the stacks or one layer's slice of a stack; none is a
    whole stack. Each split stack is gathered once a layer in the forward
    and once more in the recomputing backward."""
    cfg = get_config(QWEN).reduced(**OVERRIDES[QWEN])
    params = build_model(cfg).init_params(torch.Generator().manual_seed(0))
    stacks = [tuple(x.shape) for x in tree_leaves(params["layers"])]
    outside = [tuple(params["embed"].shape)]
    gathered = qwen4[0]["gathered"]
    assert gathered
    assert not set(gathered) & set(stacks)
    assert set(gathered) <= set(outside) | {s[1:] for s in stacks}
    split = sum(1 for x in qwen4[0]["params_layout"]["layers"][0].values()
                for y in (x.values() if isinstance(x, dict) else [x])
                if y[0] != "Replicate")
    assert len(gathered) == 1 + 2 * cfg.n_layers * split


# -- the numbers against one process ----------------------------------------------


@pytest.mark.parametrize("arch", [QWEN, GRANITE])
def test_first_refresh_equals_one_process_of_four_silos(arch, qwen4,
                                                        granite4):
    rec = qwen4[0] if arch == QWEN else granite4
    want = one_process(arch, "fednl", 4, steps=STEPS if arch == QWEN else 2)
    assert _bitwise(rec["h1"], want["h1"])
    assert _bitwise(rec["l1"], want["l1"])
    assert rec["loss"][0] == pytest.approx(want["loss"][0], rel=REL, abs=0)


@pytest.mark.parametrize("optimizer", ["fednl", "adamw"])
def test_six_steps_follow_one_process(optimizer, qwen4):
    rec = qwen4[0 if optimizer == "fednl" else 1]
    want = one_process(QWEN, optimizer, 4)
    assert len(rec["loss"]) == STEPS
    _close(rec["loss"], want["loss"])
    _close(rec["gnorm"], want["gnorm"])
    assert rec["loss"][-1] < rec["loss"][0]


def test_granite_steps_follow_one_process(granite4):
    want = one_process(GRANITE, "fednl", 4, steps=2)
    _close(granite4["loss"], want["loss"])
    _close(granite4["gnorm"], want["gnorm"])


def test_a_batch_that_does_not_split_over_the_ranks_raises(qwen4):
    rec = qwen4[2]
    assert rec["error"] is not None and "4 ranks" in rec["error"]
    assert rec["loss"] == [] and "params_layout" not in rec


def test_microbatches_that_do_not_split_a_ranks_rows_raise(qwen4):
    """8 rows over 4 ranks leave 2 a rank: 4 microbatches raise before
    any step work, on every rank alike."""
    rec = qwen4[3]
    assert "microbatches=4" in rec["error"] and rec["loss"] == []


@pytest.mark.parametrize("optimizer", ["fednl", "adamw"])
def test_one_rank_mesh_is_the_step_without_a_mesh(optimizer):
    """The driver on a one-rank mesh (DTensors, the hooks installed, the
    layout's collectives) gives what the step without a mesh gives, bit
    for bit: losses, grad norms and the final params."""
    with one_rank_group():
        rec = driver_run(None, QWEN, OVERRIDES[QWEN], argv(optimizer))
    want = one_process(QWEN, optimizer, 1)
    assert rec["loss"] == want["loss"] and rec["gnorm"] == want["gnorm"]
    assert _bitwise(rec["params"], want["params"])
    if optimizer == "fednl":
        assert _bitwise(rec["h1"], want["h1"])


# -- serving ----------------------------------------------------------------------------


@pytest.mark.parametrize("greedy", [True, False])
def test_generate_on_two_ranks_is_one_process(greedy, tmp_path):
    """Greedy tokens, and tokens sampled from whole-batch draws, token for
    token: each rank decodes its 2 rows of 4 and every rank returns all
    4."""
    got = run_group(generate_run, 2, tmp_path, QWEN, 4, 5, 6, greedy, 3)
    want = generate(QWEN, smoke=True, batch=4, prompt_len=5, gen=6, seed=3,
                    greedy=greedy, device="cpu")
    assert got.shape == (4, 11) and torch.equal(got, want)
