"""The port's kernel autotuner (``repro_torch.kernels.tuning``), test for
test against ``tests/test_tuning.py``: cache keys and persistence, the
wrappers' resolution (explicit argument > tuned winner > untuned
default), the measurement seam, and the shared-memory and register
budget of every candidate as the ``smem-budget`` analysis rule prices it.

Parity with the reference on the same inputs: ``bucket`` and
``cache_key`` give the reference's strings; ``_measure_winner`` with the
same stub timer picks the reference's winner; under every K2 candidate
plan the kernel's plain emulation (``test_torch_scatter_accum.emulate``)
equals the reference's ``scatter_accumulate_ref`` bit for bit in f64;
the streamed server sum and its slab update equal the reference's
portable streamed path bit for bit; K7 at every tuned block equals the
reference's kernel (H exactly, the norm to rtol 1e-6: f32 squares summed
per tile in another order). Every test restores the process-global cache
(``set_cache(None)``), as the reference's fixture does.
"""

import json

import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)
from repro_torch.analysis import Target, get_rule
from repro_torch.analysis.trace_utils import call_kernel, trace
from repro_torch.kernels import SMEM_BUDGET_BYTES, resources
from repro_torch.kernels.flash_attention import resolve_tiles
from repro_torch.kernels.hess_update import hess_update, resolve_block
from repro_torch.kernels.scatter_accum import (
    plan,
    resolve_plan,
    scatter_accumulate,
    scatter_accumulate_ref,
    streamed_scatter_accumulate,
    streamed_slab_update,
)
from repro_torch.kernels.tuning import (
    CACHE_ENV,
    KernelConfig,
    TuningCache,
    autotune_scatter_accumulate,
    bucket,
    cache_key,
    flash_candidates,
    get_cache,
    lookup,
    record,
    scatter_candidates,
    set_cache,
)
from repro_torch.kernels.tuning import analysis_targets as tuning_targets
from repro_torch.kernels.tuning.tuner import HESS_BLOCKS, _measure_winner


@pytest.fixture(autouse=True)
def fresh_cache():
    """Each test runs against its own empty process-global cache; reset
    to the lazy env load afterwards so other test modules see a clean
    state."""
    set_cache(TuningCache())
    yield
    set_cache(None)


def _pairs(shape, k, n, seed=0, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    vals = torch.from_numpy(rng.standard_normal((n, k))).to(dtype)
    idx = torch.from_numpy(rng.integers(0, shape[0] * shape[1], (n, k))
                           .astype(np.int32))
    return vals, idx


def _k2_plan(shape, k, n, dtype=torch.float32, **fields):
    return resolve_plan(n, k, shape[0], shape[1], False, dtype, "cpu",
                        **fields)


# -- cache keys ---------------------------------------------------------------


def test_bucket_next_pow2_min8():
    assert [bucket(x) for x in (1, 8, 9, 128, 300, 4096)] == \
        [8, 8, 16, 128, 512, 4096]


def test_cache_key_deterministic_and_bucketed():
    a = cache_key("scatter_accumulate", shape=(300, 300), k=64, n=4,
                  dtype=torch.float32)
    b = cache_key("scatter_accumulate", shape=(500, 400), k=64, n=4,
                  dtype=torch.float32)
    assert a == b  # both dims bucket to 512 — one entry serves nearby d
    assert a == cache_key("scatter_accumulate", shape=(300, 300), k=64,
                          n=4, dtype=torch.float32)
    assert a != cache_key("scatter_accumulate", shape=(300, 300), k=65,
                          n=4, dtype=torch.float32)
    assert a != cache_key("scatter_accumulate", shape=(300, 300), k=64,
                          n=4, dtype=torch.float64)
    assert a.startswith("scatter_accumulate|d512x512|k64|n4|float32|")
    # K9's key: (T, hd), n_rep, window — hd 64 and 128 never share one
    assert cache_key("flash_attention", shape=(32768, 64), k=7,
                     dtype=torch.bfloat16) != cache_key(
        "flash_attention", shape=(32768, 128), k=7, dtype=torch.bfloat16)


def test_lookup_miss_returns_none():
    assert lookup("scatter_accumulate", shape=(64, 64), k=8, n=2,
                  dtype=torch.float32) is None


def test_record_then_lookup_round_trip():
    cfg = KernelConfig(log_r=7, digit_bits=5, seg=64)
    record("scatter_accumulate", cfg, shape=(900, 900), k=128, n=8,
           dtype=torch.float32)
    got = lookup("scatter_accumulate", shape=(1000, 600), k=128, n=8,
                 dtype=torch.float32)  # same (1024, 1024) bucket
    assert got == cfg


# -- JSON persistence ---------------------------------------------------------


def test_cache_json_persistence_round_trip(tmp_path):
    c = TuningCache()
    k1 = cache_key("scatter_accumulate", shape=(512, 512), k=512, n=4,
                   dtype=torch.float32)
    k2 = cache_key("hess_update", shape=(300, 123), dtype=torch.bfloat16)
    k3 = cache_key("flash_attention", shape=(4096, 128), k=8,
                   dtype=torch.bfloat16, device="NVIDIA_H100_80GB_HBM3")
    c.put(k1, KernelConfig(log_r=8, digit_bits=11, seg=256))
    c.put(k2, KernelConfig(block=256))
    c.put(k3, KernelConfig(bq=128, bk=64))
    path = tmp_path / "cache.json"
    c.save(str(path))
    loaded = TuningCache.load(str(path))
    assert loaded.entries() == c.entries()
    # the persisted form is a plain {key: config} object + schema pin
    doc = json.loads(path.read_text())
    assert doc["schema"] == 1
    assert doc["configs"][k1] == {"log_r": 8, "digit_bits": 11, "seg": 256}


def test_cache_schema_mismatch_raises(tmp_path):
    path = tmp_path / "stale.json"
    path.write_text(json.dumps({"schema": 99, "configs": {}}))
    with pytest.raises(ValueError, match="schema"):
        TuningCache.load(str(path))


def test_env_pinned_cache_loads_lazily(tmp_path, monkeypatch):
    c = TuningCache()
    k1 = cache_key("scatter_accumulate", shape=(512, 512), k=512, n=4,
                   dtype=torch.float32)
    c.put(k1, KernelConfig(log_r=9, digit_bits=10, seg=128))
    path = tmp_path / "pin.json"
    c.save(str(path))
    assert CACHE_ENV == "REPRO_TORCH_TUNING_CACHE"  # not the reference's
    monkeypatch.setenv(CACHE_ENV, str(path))
    set_cache(None)  # reset: next get_cache() performs the env load
    assert get_cache().get(k1) == KernelConfig(log_r=9, digit_bits=10,
                                               seg=128)


# -- dispatch authority -------------------------------------------------------


def test_dispatch_honors_cached_plan():
    """A call with no plan resolves to exactly the explicit-plan call once
    the cache holds a winner, and differently from the empty-cache
    default; the sum is the plain version's, bit for bit."""
    shape = (64, 256)
    vals, idx = _pairs(shape, k=32, n=3)
    base = _k2_plan(shape, 32, 3)  # empty cache: the untuned plan
    assert base == plan(3, 32, 64, 256, False, 4)
    cfg = KernelConfig(log_r=5, digit_bits=5, seg=32)
    assert (cfg.log_r, cfg.digit_bits, cfg.seg) != (base.log_r,
                                                    base.digit_bits, base.seg)
    record("scatter_accumulate", cfg, shape=shape, k=32, n=3,
           dtype=vals.dtype)
    tuned = _k2_plan(shape, 32, 3)
    assert tuned == _k2_plan(shape, 32, 3, log_r=5, digit_bits=5, seg=32)
    assert tuned != base
    out = scatter_accumulate(vals, idx, shape)
    assert torch.equal(out, scatter_accumulate_ref(vals, idx, shape))


def test_explicit_override_beats_cache():
    """An explicit field wins over a cached winner (the cache is consulted
    only when every field is None)."""
    shape = (64, 256)
    record("scatter_accumulate", KernelConfig(log_r=5, digit_bits=5, seg=32),
           shape=shape, k=32, n=3, dtype=torch.float32)
    forced = _k2_plan(shape, 32, 3, log_r=6, seg=64)
    assert (forced.log_r, forced.seg) == (6, 64)
    assert forced != _k2_plan(shape, 32, 3)
    record("hess_update", KernelConfig(block=64), shape=(40, 56),
           dtype=torch.float64)
    assert resolve_block((40, 56), torch.float64, "cpu") == 64
    assert resolve_block((40, 56), torch.float64, "cpu", 16) == 16
    record("flash_attention", KernelConfig(bq=64, bk=64), shape=(384, 64),
           k=2, dtype=torch.float32)
    assert resolve_tiles(384, 64, 2, None, torch.float32, "cpu") == (64, 64)
    assert resolve_tiles(384, 64, 2, None, torch.float32, "cpu",
                         bq=128) == (128, 128)


def test_topk_dispatch_ignores_the_cache():
    """The top-k family has no tuned knob: the reference's only one is
    kernel-versus-oracle dispatch, whose port counterpart (the plain
    version on a card) no wrapper takes. A cache entry under its key
    changes nothing, and the tuner offers no autotune for it."""
    from repro_torch.kernels import tuning
    from repro_torch.kernels.block_topk import block_topk_payload

    assert not hasattr(tuning, "autotune_block_topk_payload")
    assert not hasattr(tuning, "autotune_diff_topk_payload")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((256, 256)))
    want = block_topk_payload(x, 16, 128)
    record("block_topk_payload", KernelConfig(block=64), shape=x.shape, k=16,
           n=128, dtype=x.dtype)
    got = block_topk_payload(x, 16, 128)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# -- the measurement loop -----------------------------------------------------


def test_autotune_records_winner_deterministically():
    """With the deterministic timer seam the tuner picks the same winner
    twice and leaves it in the cache under the dispatch key."""
    shape = (64, 256)
    vals, idx = _pairs(shape, k=32, n=3)

    def stub_timer(fn):  # never times the call: pure selection test
        stub_timer.calls += 1
        return float(stub_timer.calls)  # first measured candidate wins

    stub_timer.calls = 0
    w1 = autotune_scatter_accumulate(vals, idx, shape, timer=stub_timer)
    stub_timer.calls = 0
    w2 = autotune_scatter_accumulate(vals, idx, shape, timer=stub_timer,
                                     record_winner=False)
    assert w1 == w2
    assert lookup("scatter_accumulate", shape=shape, k=32, n=3,
                  dtype=vals.dtype) == w1


def test_autotune_winner_is_numerically_exact():
    """Whatever plan the tuner lands on, the sum equals the plain version
    bit for bit (a plan changes scheduling, never values)."""
    shape = (64, 256)
    vals, idx = _pairs(shape, k=32, n=3, seed=5)
    autotune_scatter_accumulate(vals, idx, shape, timer=lambda fn: 1.0,
                                max_measured=8)
    out = scatter_accumulate(vals, idx, shape)
    assert torch.equal(out, scatter_accumulate_ref(vals, idx, shape))


# -- the shared-memory and register budget ------------------------------------


def _smem_violations(tr):
    t = Target(name="test", kind="kernel", trace=lambda: None, rules=(),
               context={})
    return get_rule("smem-budget").check(tr, t)


def test_candidates_fit_smem_budget_when_traced():
    """Every candidate the generator emits traces within the budget the
    smem-budget rule enforces — the tuner can never pick a config the
    analysis would reject."""
    shape, k, n = (4096, 4096), 2048, 4
    cands = scatter_candidates(shape, k, n, torch.float32)
    assert cands, "candidate pool must not be empty"
    vals, idx = _pairs((64, 64), k, n)   # the plan is priced, not the sum
    for cfg in cands:
        tr = trace(lambda v, i, cfg=cfg: call_kernel(
            "scatter_accumulate", v, i, (64, 64), log_r=cfg.log_r,
            digit_bits=cfg.digit_bits, seg=cfg.seg), vals, idx)
        assert _smem_violations(tr) == [], f"config {cfg} over budget"


def test_candidate_pool_gated_by_budget(monkeypatch):
    """A tile pair whose launch would be over a block's registers is not
    offered: with the wgmma kernel at (hd 128, 128, 128) built at 255
    registers, 288 threads would need 73,440 of the SM's 65,536."""
    full = flash_candidates(128, torch.bfloat16)
    assert KernelConfig(bq=128, bk=128) in full and len(full) == 4
    kernel = "flash_attention_kernel_wgmma<128, 128, 128>"
    monkeypatch.setitem(resources.BUILD, kernel, (255, 64))
    gated = flash_candidates(128, torch.bfloat16)
    assert KernelConfig(bq=128, bk=128) not in gated and len(gated) == 3
    assert SMEM_BUDGET_BYTES == 232_448


def test_budget_guard_outranks_cache(monkeypatch):
    """A hand-pinned or stale entry the kernel cannot launch (a digit
    wider than 11 bits, a tile outside {64, 128}, a block <= 0, a pair
    over the register budget) gives way to the untuned kernel config,
    never to the plain version."""
    shape = (64, 256)
    record("scatter_accumulate", KernelConfig(log_r=5, digit_bits=12, seg=32),
           shape=shape, k=32, n=3, dtype=torch.float32)
    assert _k2_plan(shape, 32, 3) == plan(3, 32, 64, 256, False, 4)
    record("hess_update", KernelConfig(block=-4), shape=(40, 56),
           dtype=torch.float64)
    assert resolve_block((40, 56), torch.float64, "cpu") == 128
    record("flash_attention", KernelConfig(bq=96, bk=64), shape=(384, 64),
           k=2, dtype=torch.bfloat16)
    assert resolve_tiles(384, 64, 2, None, torch.bfloat16, "cpu") == (128, 128)
    monkeypatch.setitem(resources.BUILD,
                        "flash_attention_kernel_wgmma<128, 128, 64>",
                        (255, 112))                # 288 threads x 255 > 65,536
    record("flash_attention", KernelConfig(bq=128, bk=64), shape=(4096, 128),
           k=8, dtype=torch.bfloat16)
    assert resolve_tiles(4096, 128, 8, None, torch.bfloat16, "cpu") == \
        (128, 128)
    with pytest.raises(ValueError, match="cannot launch"):
        _k2_plan(shape, 32, 3, digit_bits=12)


# -- analysis integration -----------------------------------------------------


def test_tuning_analysis_targets_enumerate_cache():
    """Each cached winner becomes an analysis target priced by the
    smem-budget rule; with an empty cache the defaults are traced."""
    empty = tuning_targets()
    assert empty and all("default" in t["name"] for t in empty)
    record("scatter_accumulate", KernelConfig(log_r=6, digit_bits=11,
                                              seg=512),
           shape=(4096, 4096), k=2048, n=4, dtype=torch.float32)
    record("hess_update", KernelConfig(block=256), shape=(512, 512),
           dtype=torch.float32)
    record("flash_attention", KernelConfig(bq=64, bk=128), shape=(4096, 128),
           k=8, dtype=torch.bfloat16)
    targets = tuning_targets()
    names = " ".join(t["name"] for t in targets)
    assert "tuned:" in names and len(targets) == 3
    for t in targets:
        tr = t["trace"]()  # must run cleanly...
        assert sum(op.is_kernel for op in tr.ops) == 1
        assert _smem_violations(tr) == []  # ...and price in budget


def test_analyze_sweep_includes_tuning_package():
    from repro_torch.analysis.targets import analyze

    results = analyze(kinds=["kernel"], targets=["tuning"])
    assert results, "tuning package must contribute kernel targets"
    for t, violations in results:
        assert violations == [], f"{t.name}: {violations}"


# -- parity with the reference ------------------------------------------------


_DTYPES = [("float32", torch.float32), ("float64", torch.float64),
           ("bfloat16", torch.bfloat16), ("float16", torch.float16),
           ("int32", torch.int32)]


@pytest.mark.parametrize("seed", range(4))
def test_bucket_and_cache_key_match_reference(seed):
    import jax.numpy as jnp
    from repro.kernels.tuning import bucket as jax_bucket
    from repro.kernels.tuning import cache_key as jax_cache_key

    rng = np.random.default_rng(seed)
    for _ in range(25):
        x = int(rng.integers(1, 70000))
        assert bucket(x) == jax_bucket(x)
        shape = tuple(int(s) for s in rng.integers(1, 5000,
                                                   int(rng.integers(1, 4))))
        k = None if rng.random() < 0.3 else int(rng.integers(1, 4096))
        n = None if rng.random() < 0.3 else int(rng.integers(1, 300))
        name, tdt = _DTYPES[int(rng.integers(len(_DTYPES)))]
        op = ["scatter_accumulate", "hess_update", "flash_attention"][
            int(rng.integers(3))]
        want = jax_cache_key(op, shape=shape, k=k, n=n,
                             dtype=getattr(jnp, name), device="NVIDIA_H100")
        assert cache_key(op, shape=shape, k=k, n=n, dtype=tdt,
                         device="NVIDIA_H100") == want


def test_measure_winner_matches_reference():
    """The same candidates, prediction and stub timer give the reference's
    winner and timings (pruning to the best predicted, ties to the first
    measured)."""
    from repro.kernels.tuning.tuner import _measure_winner as jax_measure

    rng = np.random.default_rng(3)
    cands = [f"c{i}" for i in range(12)]
    pred = {c: float(rng.integers(0, 5)) for c in cands}
    times = [float(x) for x in rng.integers(1, 4, 12)]
    for max_measured in (3, 5, 12):
        got = []
        for measure in (_measure_winner, jax_measure):
            it = iter(times)
            got.append(measure(cands, lambda c: c, pred.__getitem__,
                               max_measured, 1, lambda fn: next(it)))
        assert got[0] == got[1]


@pytest.mark.parametrize("shape,k,n,symmetric", [
    ((24, 24), 40, 13, False), ((24, 24), 40, 13, True),
    ((40, 56), 16, 6, False)])
def test_every_k2_candidate_plan_emulates_reference_bitwise(shape, k, n,
                                                            symmetric):
    """Under each plan of the tuner's pool, the CUDA kernel's emulation
    equals the reference's ``scatter_accumulate_ref`` in f64, bit for bit
    (symmetric pairs lower-triangular, where the reference's two-pass
    mirror and the kernel's fused one add the same values)."""
    import jax
    import jax.numpy as jnp
    from repro.kernels.scatter_accum import (
        scatter_accumulate_ref as jax_scatter_ref,
    )
    from test_torch_scatter_accum import emulate

    rng = np.random.default_rng(29)
    vals = rng.standard_normal((n, k))
    idx = rng.integers(-1, shape[0] * shape[1], (n, k))
    if symmetric:
        r, c = np.divmod(np.where(idx < 0, 0, idx), shape[1])
        idx = np.where(idx < 0, -1, np.maximum(r, c) * shape[1]
                       + np.minimum(r, c))
    idx = idx.astype(np.int32)
    with jax.enable_x64(True):
        want = np.asarray(jax_scatter_ref(jnp.asarray(vals), jnp.asarray(idx),
                                          shape, symmetric=symmetric))
    v, i = torch.from_numpy(vals), torch.from_numpy(idx)
    pool = scatter_candidates(shape, k, n, torch.float64, symmetric)
    assert len(pool) > 20
    for cfg in pool:
        got = emulate(v, i, shape, symmetric, log_r=cfg.log_r,
                      digit_bits=cfg.digit_bits, seg=cfg.seg)
        assert np.array_equal(got.numpy(), want), cfg


def _reference_stream(n, k, shape, pad_rows):
    """The reference's ``_pair_stream`` draw, as numpy arrays."""
    import jax
    import jax.numpy as jnp

    d0, d1 = shape
    kv, ki = jax.random.split(jax.random.PRNGKey(0))
    vals = jax.random.normal(kv, (n, k), dtype=jnp.float64)
    idx = jax.random.randint(ki, (n, k), 0, d0 * d1, dtype=jnp.int32)
    for r in pad_rows:
        idx = idx.at[r].set(-1)  # an all-padding silo
    return np.array(vals), np.array(idx)


@pytest.mark.parametrize("silo_chunk", [1, 2, 3, 7, None])
@pytest.mark.parametrize("symmetric", [False, True])
def test_streamed_matches_reference_bitwise(silo_chunk, symmetric):
    """The port's streamed sum equals the reference's portable streamed
    path bit for bit, across every slab alignment and with all-padding
    slabs (silos 10 and 11 form one at silo_chunk=2); without a mirror
    it also equals the port's stacked K2 call."""
    import jax
    import jax.numpy as jnp
    from repro.kernels.scatter_accum import (
        streamed_scatter_accumulate as jax_streamed,
    )

    shape = (24, 24)
    with jax.enable_x64(True):
        vals, idx = _reference_stream(13, 40, shape, (3, 10, 11, 12))
        want = np.asarray(jax_streamed(jnp.asarray(vals), jnp.asarray(idx),
                                       shape, silo_chunk=silo_chunk,
                                       use_pallas=False, symmetric=symmetric))
    got = streamed_scatter_accumulate(vals, idx, shape, silo_chunk=silo_chunk,
                                      symmetric=symmetric)
    assert np.array_equal(got.numpy(), want)
    if not symmetric:
        stacked = scatter_accumulate(torch.from_numpy(vals),
                                     torch.from_numpy(idx), shape)
        assert torch.equal(got, stacked)


@pytest.mark.parametrize("cut", [(5,), (1, 2), (4, 9), (10, 12)])
def test_streamed_slab_update_matches_reference_bitwise(cut):
    """Chained slab updates (K2 seeded with the running sum) equal the
    reference's portable slab update chained the same way, bit for bit,
    and the one stacked sum; (10, 12) cuts out the all-padding slab."""
    import jax
    import jax.numpy as jnp
    from repro.kernels.scatter_accum.ops import _streamed_ref_slab

    shape = (24, 24)
    bounds = (0,) + cut + (13,)
    with jax.enable_x64(True):
        vals, idx = _reference_stream(13, 40, shape, (3, 10, 11))
        acc = jnp.zeros(shape, jnp.float64)
        for a, b in zip(bounds, bounds[1:]):
            acc = _streamed_ref_slab(acc, jnp.asarray(vals[a:b]),
                                     jnp.asarray(idx[a:b]), shape)
        want = np.asarray(acc)
    got = torch.zeros(shape, dtype=torch.float64)
    for a, b in zip(bounds, bounds[1:]):
        got = streamed_slab_update(got, torch.from_numpy(vals[a:b]),
                                   torch.from_numpy(idx[a:b]), shape)
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(got, scatter_accumulate(torch.from_numpy(vals),
                                               torch.from_numpy(idx), shape))


@pytest.mark.parametrize("block", HESS_BLOCKS)
def test_hess_update_at_each_tuned_block_matches_reference(block):
    """K7 at every block the tuner offers: H + alpha S equal to the
    reference's kernel bit for bit, ||H - D||_F to rtol 1e-6; a cached
    block is what a call without one runs."""
    import jax
    import jax.numpy as jnp
    from repro.kernels.hess_update import hess_update as jax_hess_update

    rng = np.random.default_rng(block)
    h, d, s = (rng.standard_normal((300, 123)) for _ in range(3))
    with jax.enable_x64(True):
        want_out, want_l = jax_hess_update(jnp.asarray(h), jnp.asarray(d),
                                           jnp.asarray(s), 0.37, block=block,
                                           interpret=True)
        want_out, want_l = np.asarray(want_out), float(want_l)
    ht, dt, st = (torch.from_numpy(x) for x in (h, d, s))
    out, l = hess_update(ht, dt, st, 0.37, block=block)
    assert np.array_equal(out.numpy(), want_out)
    np.testing.assert_allclose(float(l), want_l, rtol=1e-6)
    record("hess_update", KernelConfig(block=block), shape=(300, 123),
           dtype=torch.float64)
    cached = hess_update(ht, dt, st, 0.37)
    assert torch.equal(cached[0], out) and torch.equal(cached[1], l)
