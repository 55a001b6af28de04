"""The port's multi-device aggregation (``core/federated.py``,
``kernels/scatter_accum/sharded.py``, ``launch/mesh.py`` and
``launch/sharding.py``) against the JAX reference.

Process groups are gloo groups on the CPU: four spawned ranks
(``_torch_dist.run_group``, one group per test) or this process alone
(``one_rank_group``). Tolerances:
- the row-window functions and the sharded sum equal the reference's
  bit for bit (K2's plain version sums each cell in stream order, and so
  does the reference's scatter);
- FedNL split over 4 ranks agrees with the reference's unsharded run to
  1e-10 for the compressors whose selection no mirror tie decides
  (symmetric Top-K and Rank-R); plain Top-K and Block-Top-K are held at
  the server instead: the reduced mean of payloads split over 4 ranks
  equals the unsharded ``aggregate`` to 1e-14;
- the sharding rules give the reference's ``PartitionSpec`` entries
  exactly.

Every JAX computation runs inside ``jax.enable_x64(True)``.
"""

import functools
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dist import (
    fednl_runs,
    one_rank_group,
    run_group,
    sharded_sums,
    split_aggregates,
)
from _torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)
from repro.configs import get_config as jax_get_config
from repro.core.compressors import make_compressor as jax_make_compressor
from repro.core.federated import run_fednl_sharded as jax_run_fednl_sharded
from repro.core.fednl import FedNL as JaxFedNL
from repro.core.objectives import batch_grad, batch_hess
from repro.data.synthetic import make_synthetic
from repro.kernels.scatter_accum.ref import scatter_accumulate_ref
from repro.kernels.scatter_accum.sharded import (
    mirror_expand_pairs as jax_mirror_expand_pairs,
)
from repro.kernels.scatter_accum.sharded import (
    row_window_scatter as jax_row_window_scatter,
)
from repro.launch import sharding as jax_sharding
from repro.models import build_model as jax_build_model
from repro.models import common as jax_common
from repro_torch.core import make_compressor, run_fednl_sharded
from repro_torch.interop import logreg_from_numpy
from repro_torch.kernels.scatter_accum.sharded import (
    mirror_expand_pairs,
    row_window_scatter,
    windowed_scatter_accumulate,
)
from repro_torch.launch import sharding
from repro_torch.launch.mesh import batch_axes, extents, make_host_mesh

N, M, D = 8, 30, 10
ROUNDS = 6
MU = 1e-3
RUNS = [("topk-sym", 10, 1), ("topk-sym", 10, 2), ("rankr", 1, 1),
        ("rankr", 1, 2)]
QWEN = "qwen2-0.5b"


@pytest.fixture(autouse=True)
def no_activation_sharder():
    """Run the JAX package without a mesh sharder and put back whatever
    was installed: a test elsewhere on the same worker may leave one."""
    saved = (jax_common._ACT_CONSTRAINT, jax_common._LAYER_PARAM_CONSTRAINT)
    jax_common.set_activation_sharder(None, None)
    yield
    jax_common.set_activation_sharder(*saved)


@functools.lru_cache(maxsize=None)
def synthetic() -> dict:
    """The reference's ``make_synthetic(n=8, m=30, d=10)`` as numpy, and
    x0 = 0."""
    with jax.enable_x64(True):
        data = make_synthetic(jax.random.PRNGKey(0), alpha=0.5, beta=0.5,
                              n=N, m=M, d=D)
        return dict(a=np.asarray(data.a, np.float64),
                    b=np.asarray(data.b, np.float64), lam=float(data.lam),
                    x0=np.zeros(D))


def jax_data():
    from repro.core.objectives import LogRegData

    s = synthetic()
    return LogRegData(a=jnp.asarray(s["a"]), b=jnp.asarray(s["b"]),
                      lam=s["lam"])


def reference_run(family, level, option) -> np.ndarray:
    """The reference's unsharded ``FedNL.run``'s iterates."""
    with jax.enable_x64(True):
        data = jax_data()
        alg = JaxFedNL(lambda x: batch_grad(x, data),
                       lambda x: batch_hess(x, data),
                       jax_make_compressor(family, level), option=option,
                       mu=MU)
        _, xs = alg.run(jnp.zeros(D), N, ROUNDS)
        return np.asarray(xs)


def pairs(n: int, k: int, d0: int, d1: int, seed: int, lower: bool = False):
    """(n, k) f64 values and int32 flat indices with -1 padding, one
    silo all padding (dropped); ``lower`` puts every pair on or below
    the diagonal."""
    rng = np.random.default_rng(seed)
    values = rng.standard_normal((n, k))
    r = rng.integers(0, d0, (n, k))
    c = rng.integers(0, d1, (n, k))
    if lower:
        r, c = np.maximum(r, c), np.minimum(r, c)
    idx = (r * d1 + c).astype(np.int32)
    idx[rng.random((n, k)) < 0.2] = -1
    idx[1] = -1
    return values, idx


# -- the row-window functions ----------------------------------------------------


@pytest.mark.parametrize("row0,rows_per", [(0, 4), (4, 4), (12, 4), (0, 16),
                                           (6, 3)])
def test_row_window_scatter_matches_reference(row0, rows_per):
    values, idx = pairs(5, 40, 16, 16, seed=row0 + rows_per)
    got = row_window_scatter(torch.from_numpy(values), torch.from_numpy(idx),
                             (16, 16), row0, rows_per)
    with jax.enable_x64(True):
        want = jax_row_window_scatter(jnp.asarray(values), jnp.asarray(idx),
                                      (16, 16), row0, rows_per)
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_mirror_expand_pairs_matches_reference():
    values, idx = pairs(5, 40, 16, 16, seed=3, lower=True)
    v, i = mirror_expand_pairs(torch.from_numpy(values),
                               torch.from_numpy(idx), 16)
    with jax.enable_x64(True):
        jv, ji = jax_mirror_expand_pairs(jnp.asarray(values),
                                         jnp.asarray(idx), 16)
        assert np.array_equal(v.numpy(), np.asarray(jv))
        assert np.array_equal(i.numpy(), np.asarray(ji))


@pytest.mark.parametrize("world", [1, 2, 4, 8])
@pytest.mark.parametrize("symmetric", [False, True], ids=["plain", "sym"])
def test_windows_equal_the_reference_sum_bit_for_bit(world, symmetric):
    values, idx = pairs(6, 50, 16, 16, seed=world, lower=symmetric)
    got = windowed_scatter_accumulate(torch.from_numpy(values),
                                      torch.from_numpy(idx), (16, 16), world,
                                      symmetric=symmetric)
    with jax.enable_x64(True):
        want = scatter_accumulate_ref(jnp.asarray(values), jnp.asarray(idx),
                                      (16, 16), symmetric=symmetric)
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_windows_refuse_rows_that_do_not_split():
    values, idx = pairs(2, 8, 15, 16, seed=0)
    with pytest.raises(ValueError, match="d0"):
        windowed_scatter_accumulate(torch.from_numpy(values),
                                    torch.from_numpy(idx), (15, 16), 4)


# -- four ranks -------------------------------------------------------------------


def test_sharded_sum_on_four_ranks(tmp_path):
    """The gathered sum equals ``scatter_accumulate_ref`` bit for bit,
    plain and symmetric; the symmetric one is base + base^T - diag; a
    window is (d0 / 4, d1); (15, 16) is refused, as ``accumulator_spec``
    replicates it."""
    values, idx = pairs(8, 60, 16, 16, seed=11, lower=True)
    out = run_group(sharded_sums, 4, tmp_path, values, idx, (16, 16))
    with jax.enable_x64(True):
        v, i = jnp.asarray(values), jnp.asarray(idx)
        base = np.asarray(scatter_accumulate_ref(v, i, (16, 16)))
        sym = np.asarray(scatter_accumulate_ref(v, i, (16, 16),
                                                symmetric=True))
    assert np.array_equal(out[False].numpy(), base)
    assert np.array_equal(out[True].numpy(), sym)
    np.testing.assert_allclose(out[True].numpy(),
                               base + base.T - np.diag(np.diag(base)),
                               rtol=0, atol=1e-14)
    assert out["window"] == (4, 16)
    assert out["placements"] == ["Shard0", "Replicate"]
    assert out["refused"]
    ext = {"data": 4, "model": 1}
    assert sharding.accumulator_spec(ext, (16, 16)) == ("data", None)
    assert sharding.accumulator_spec(ext, (15, 16)) == (None, None)


def test_run_fednl_sharded_on_four_ranks_matches_reference(tmp_path):
    s = synthetic()
    out = run_group(fednl_runs, 4, tmp_path, s["a"], s["b"], s["lam"],
                    s["x0"], RUNS, ROUNDS)
    assert out["local_silos"] == N // 4
    for family, level, option in RUNS:
        want = reference_run(family, level, option)
        np.testing.assert_allclose(out[family, option].numpy(), want,
                                   rtol=0, atol=1e-10,
                                   err_msg=f"{family} option {option}")


@pytest.mark.parametrize("family,level", [("topk", 10), ("blocktopk", 4)])
def test_reduced_mean_of_split_payloads_matches_reference(tmp_path, family,
                                                          level):
    """Plain Top-K and Block-Top-K pick between a Hessian diff's mirror
    entries by the last bit of a reduction order, so their sharded
    iterates are not compared; the server is: each rank's payload mean,
    summed over 4 ranks and divided, equals the reference's unsharded
    ``aggregate`` of the same diffs."""
    rng = np.random.default_rng(5)
    diffs = rng.standard_normal((N, 12, 12))
    got = run_group(split_aggregates, 4, tmp_path, family, level, diffs,
                    (12, 12))
    with jax.enable_x64(True):
        comp = jax_make_compressor(family, level)
        keys = jax.random.split(jax.random.PRNGKey(0), N)
        payloads = jax.vmap(comp.compress)(jnp.asarray(diffs), keys)
        want = np.asarray(comp.aggregate(payloads, (12, 12)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-14)


# -- one rank ----------------------------------------------------------------------


@pytest.mark.parametrize("family,level,option", RUNS)
def test_one_rank_matches_reference_sharded_run(family, level, option):
    s = synthetic()
    with one_rank_group():
        mesh = make_host_mesh(device="cpu")
        data = logreg_from_numpy(s["a"], s["b"], s["lam"], device="cpu")
        _, xs = run_fednl_sharded(data, make_compressor(family, level), mesh,
                                  torch.zeros(D, dtype=torch.float64),
                                  ROUNDS, option=option, mu=MU)
    with jax.enable_x64(True):
        jmesh = jax.make_mesh((1,), ("data",))
        _, want = jax_run_fednl_sharded(jax_data(),
                                        jax_make_compressor(family, level),
                                        jmesh, jnp.zeros(D), ROUNDS,
                                        option=option, mu=MU)
        want = np.asarray(want)
    np.testing.assert_allclose(xs.numpy(), want, rtol=0, atol=1e-10)


def test_host_mesh_on_one_rank():
    with one_rank_group():
        mesh = make_host_mesh(device="cpu")
        assert mesh.mesh_dim_names == ("data", "model")
        assert tuple(mesh.shape) == (1, 1)
        assert extents(mesh) == {"data": 1, "model": 1}
        assert batch_axes(mesh) == ("data",)
        from torch.distributed.tensor import Replicate

        for spec in (("data", "model"), (("data", "model"), None), ()):
            assert all(isinstance(p, Replicate)
                       for p in sharding.placements(mesh, spec))


def test_host_mesh_makes_its_own_group_when_started_alone():
    import torch.distributed as dist

    assert not dist.is_initialized()
    try:
        mesh = make_host_mesh(device="cpu")
        assert dist.get_world_size() == 1 and tuple(mesh.shape) == (1, 1)
    finally:
        dist.destroy_process_group()


def test_run_fednl_sharded_refuses_silos_that_do_not_split():
    s = synthetic()

    class Mesh:           # a (3,)-rank "data" axis, for the check alone
        mesh_dim_names = ("data",)

        def size(self, dim):
            return 3

    data = logreg_from_numpy(s["a"], s["b"], s["lam"], device="cpu")
    with pytest.raises(ValueError, match="8 silos"):
        run_fednl_sharded(data, make_compressor("topk", 10), Mesh(),
                          torch.zeros(D, dtype=torch.float64), 1)


# -- the sharding rules ---------------------------------------------------------------


class _StandIn:
    """What the reference's ``_spec`` and ``param_spec`` read of a mesh."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape)


MESHES = {"1x1": ((1, 1), ("data", "model")),
          "4x1": ((4, 1), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


@functools.lru_cache(maxsize=None)
def qwen_paths() -> list:
    """(path, shape) of every qwen2-0.5B parameter, from the reference's
    ``eval_shape`` of its init."""
    cfg = jax_get_config(QWEN)
    shapes = jax.eval_shape(jax_build_model(cfg).init_params,
                            jax.random.PRNGKey(0))
    out = []

    def walk(tree, prefix):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{prefix}/{k}")
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                walk(v, f"{prefix}/{i}")
        else:
            out.append((prefix, tuple(tree.shape)))

    walk(shapes, "params")
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
def test_param_spec_matches_reference(mesh):
    shape, names = MESHES[mesh]
    stand_in = _StandIn(shape, names)
    ext = dict(zip(names, shape))
    cfg = jax_get_config(QWEN)
    paths = qwen_paths()
    assert len(paths) == 14
    for path, pshape in paths:
        want = tuple(jax_sharding.param_spec(path, pshape, stand_in, cfg))
        assert sharding.param_spec(path, pshape, ext) == want, path
    for pshape, wants in [((14, 64), ("model", None)),
                          ((2, 896), (("pod", "data"), "model")),
                          ((6, 4), (("pod", "data"), None)),
                          ((3,), ("data",))]:
        want = tuple(jax_sharding._spec(stand_in, pshape, wants))
        assert sharding._spec(ext, pshape, wants) == want


# the wants that the reference's make_activation_sharder spells out
ACTIVATIONS = {
    "btd": ((4, 64, 896), lambda ba, x: (ba,) + (None,) * 2),
    "btf": ((4, 64, 4864), lambda ba, x: (ba, None, "model")),
    "bthd": ((4, 64, 14, 64), lambda ba, x: (ba, None, "model", None)),
    "logits": ((4, 64, 151936), lambda ba, x: (ba, None, "model")),
    "ecf": ((8, 16, 4, 896), lambda ba, x: (
        (ba, "model", None, None) if x["model_fits"]
        else (ba, None, None, "model"))),
    "moe_route": ((8, 16, 4), lambda ba, x: (ba, None, None)),
    "carry": ((4, 64, 896), lambda ba, x: (ba, "model", None)),
}


@pytest.mark.parametrize("kind", list(ACTIVATIONS))
@pytest.mark.parametrize("mesh", ["4x1", "2x2", "16x16", "2x16x16"])
def test_activation_rules_match_reference(kind, mesh):
    shape, names = MESHES[mesh]
    stand_in = _StandIn(shape, names)
    ext = dict(zip(names, shape))
    ba = tuple(a for a in ("pod", "data") if a in names)
    xshape, wants_of = ACTIVATIONS[kind]
    wants = wants_of(ba, {"model_fits": xshape[1] % ext["model"] == 0})
    want = tuple(jax_sharding._spec(stand_in, xshape, wants))
    assert sharding.make_activation_sharder(ext)(xshape, kind) == want
    assert sharding.make_activation_sharder(ext)(xshape, "none") is None


_NAMED_RULES = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import json
    import jax, jax.numpy as jnp
    from repro.configs import get_config
    from repro.launch import sharding as S
    from repro.launch.steps import make_optimizer
    from repro.models import build_model

    cfg = get_config("qwen2-0.5b")
    model = build_model(cfg)
    params = jax.eval_shape(model.init_params, jax.random.PRNGKey(0))
    cache = jax.eval_shape(lambda: model.init_cache(4, 64))
    batch = {"tokens": jax.ShapeDtypeStruct((4, 64), jnp.int32),
             "targets": jax.ShapeDtypeStruct((4, 64), jnp.int32)}
    spec = lambda t: jax.tree.map(lambda s: list(s.spec), t)
    out = {}
    for shape in ((4, 1), (2, 2)):
        mesh = jax.make_mesh(shape, ("data", "model"))
        key = "x".join(map(str, shape))
        row = {"params": spec(S.tree_param_specs(params, mesh, cfg)),
               "batch": spec(S.batch_specs(batch, mesh)),
               "cache": spec(S.cache_specs(cache, mesh, cfg)),
               "acc": list(S.accumulator_spec(mesh, (300, 300)).spec),
               "acc_odd": list(S.accumulator_spec(mesh, (301, 300)).spec)}
        for name in ("fednl", "adamw"):
            opt = make_optimizer(name, 1e-3)
            st = S.opt_state_shardings(jax.eval_shape(opt.init, params),
                                       params, mesh, cfg)
            row[name] = {f: spec(getattr(st, f)) for f in st._fields}
        out[key] = row
    print("RULES=" + json.dumps(out))
""")


@functools.lru_cache(maxsize=None)
def named_rules() -> dict:
    """The reference's NamedSharding rules' specs on 4 forced host
    devices (a subprocess, so the device count stays there)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", _NAMED_RULES], env=env,
                         capture_output=True, text=True, timeout=300)
    line = [x for x in out.stdout.splitlines() if x.startswith("RULES=")]
    assert line, out.stdout + out.stderr
    return json.loads(line[0][len("RULES="):])


def _as_lists(tree):
    """The port's specs in the JSON form of the reference's."""
    if hasattr(tree, "_fields"):
        return {f: _as_lists(getattr(tree, f)) for f in tree._fields}
    if isinstance(tree, dict):
        return {k: _as_lists(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_lists(v) for v in tree]
    if isinstance(tree, tuple):
        return [list(e) if isinstance(e, tuple) else e for e in tree]
    return tree


def _json(tree):
    return json.loads(json.dumps(tree))


def port_trees():
    """The port's qwen2-0.5B params (``param_shapes``), a decode cache
    and a batch, as meta tensors."""
    from repro_torch.configs import get_config
    from repro_torch.configs.qwen2_0_5b import param_shapes
    from repro_torch.models import build_model
    from repro_torch.tree import tree_map

    params = tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                            device="meta"), param_shapes())
    cache = build_model(get_config(QWEN)).init_cache(4, 64, device="meta")
    batch = {"tokens": torch.empty((4, 64), dtype=torch.int32, device="meta"),
             "targets": torch.empty((4, 64), dtype=torch.int32,
                                    device="meta")}
    return params, cache, batch


@pytest.mark.parametrize("rule", ["params", "batch", "cache", "acc", "fednl",
                                  "adamw"])
@pytest.mark.parametrize("mesh", ["4x1", "2x2"])
def test_named_sharding_rules_match_reference(rule, mesh):
    from repro_torch.launch.steps import make_optimizer

    want = named_rules()[mesh][rule]
    ext = dict(zip(("data", "model"), map(int, mesh.split("x"))))
    params, cache, batch = port_trees()
    if rule == "params":
        got = sharding.tree_param_specs(params, ext)
    elif rule == "batch":
        got = sharding.batch_specs(batch, ext)
    elif rule == "cache":
        got = sharding.cache_specs(cache, ext)
    elif rule == "acc":
        got = sharding.accumulator_spec(ext, (300, 300))
        assert (_as_lists(sharding.accumulator_spec(ext, (301, 300)))
                == named_rules()[mesh]["acc_odd"])
    else:
        opt = make_optimizer(rule, 1e-3)
        got = sharding.opt_state_shardings(opt.init(params), params, ext)
    assert _json(_as_lists(got)) == want
