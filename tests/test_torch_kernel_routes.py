"""How the port's wrappers pick a kernel, on the CPU: K8's route for each
product shape and stride, K9's route for each input type, the checks both
make before a launch, K9's bf16 tolerance helper, and the build's
flags. The kernels themselves run only on a card
(``tests/test_torch_cuda.py``); here each wrapper runs its plain version,
which must stay what the JAX package computes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import one_torch_thread  # noqa: F401

from repro.kernels.tiled_matmul import tiled_matmul as jax_tiled_matmul
from repro_torch.kernels import LAUNCHES, ROUTES, _cuda, reset_launches
from repro_torch.kernels.flash_attention import (
    BF16_MAX_ERR,
    BF16_MEAN_VS_LIBRARY,
    BF16_ROW_ERR,
    bf16_attention_check,
    flash_attention,
    route,
    tma_strides,
)
from repro_torch.kernels.tiled_matmul import (
    plan,
    tiled_matmul,
    tiled_matmul_ref,
)

# -- K8: tiled_matmul ---------------------------------------------------------

M, K = 896, 4864   # layers.ffn.wg[0] of qwen2-0.5B


@pytest.mark.parametrize("m,n,k,strides,aligned,want", [
    # the power iteration on wg[0], r = 2: (a) M @ Q, row-major A, one
    # block per row fills the card
    (M, 2, K, (K, 1), True, ("small_n", 1, K)),
    # (b) M^T @ P, a column-major view: 38 row tiles, K cut into 14
    # chunks of 64 (528 blocks)
    (K, 2, M, (1, K), True, ("small_n", 14, 64)),
    # (c) P @ Q^T, K = 2: the outer-product route, 16-byte stores
    (M, K, 2, (2, 1), True, ("small_k", 1, 0)),
    # r = 1
    (M, 1, K, (K, 1), True, ("small_n", 1, K)),
    (K, 1, M, (1, K), True, ("small_n", 14, 64)),
    # few rows: K is cut so the blocks fill the card
    (8, 2, 8192, (8192, 1), True, ("small_n", 16, 512)),
    # no 16-byte loads, so tiled: a misaligned address, a row length or
    # row count that is not a multiple of 4
    (M, 2, K, (K, 1), False, ("tiled", 1, 0)),
    (299, 3, 301, (301, 1), True, ("tiled", 1, 0)),
    (301, 3, 299, (1, 301), True, ("tiled", 1, 0)),
    # N or K of 8 is still skinny, 9 is not; no 16-byte stores for an
    # output width that is not a multiple of 4; a square product is tiled
    (M, 8, K, (K, 1), True, ("small_n", 1, K)),
    (M, 9, K, (K, 1), True, ("tiled", 1, 0)),
    (M, K, 8, (8, 1), True, ("small_k", 1, 0)),
    (M, 4862, 8, (8, 1), True, ("tiled", 1, 0)),
    (K, M, M, (1, K), True, ("tiled", 1, 0)),
    (300, 300, 300, (300, 1), True, ("tiled", 1, 0)),
])
def test_tiled_matmul_route_for_each_shape_and_stride(m, n, k, strides,
                                                      aligned, want):
    assert tuple(plan(m, n, k, strides, aligned)) == want


@pytest.mark.parametrize("m,k", [(0, 5), (5, 0), (1, 1)])
def test_tiled_matmul_route_of_degenerate_shapes(m, k):
    """Empty products and a 1 x 1 A, row-major: no rows of 16 bytes, so
    they are tiled, which covers them whole."""
    assert tuple(plan(m, 2, k, (max(k, 1), 1), True)) == ("tiled", 1, 0)


def test_tiled_matmul_route_of_an_empty_k():
    """An empty K on a column-major A takes the small-N route with one
    chunk, which writes zeros."""
    assert tuple(plan(4, 2, 0, (1, 4), True)) == ("small_n", 1, 4)


@pytest.mark.parametrize("name", ["a", "b", "c", "square"])
def test_tiled_matmul_plain_version_is_unchanged(name):
    """On the CPU each product of the power iteration is the plain f32
    matmul, bit for bit, within 1e-5 of the largest entry of the JAX
    kernel (interpret mode), and counts no launch."""
    rng = np.random.default_rng(3)
    m = torch.from_numpy(rng.standard_normal((60, 90), dtype=np.float32))
    q, p = (torch.linalg.qr(torch.from_numpy(
        rng.standard_normal((n, 2), dtype=np.float32)))[0] for n in (90, 60))
    a, b = {"a": (m, q), "b": (m.T, p), "c": (p, q.T),
            "square": (m.T, m[:, :60])}[name]
    before = dict(LAUNCHES)
    got = tiled_matmul(a, b)
    assert LAUNCHES == before
    assert torch.equal(got, tiled_matmul_ref(a, b))
    want = np.asarray(jax_tiled_matmul(jnp.asarray(a.numpy()),
                                       jnp.asarray(b.numpy()), interpret=True))
    gap = np.abs(got.numpy() - want).max()
    assert gap <= 1e-5 * np.abs(want).max()


# -- K9: flash_attention ------------------------------------------------------


def test_flash_attention_route_by_dtype():
    """bf16 takes the tensor-core kernel, f32 the FFMA kernel; nothing else
    has a route."""
    assert route(torch.bfloat16) == "wgmma"
    assert route(torch.float32) == "ffma"
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(TypeError, match="bf16 or f32"):
            route(dtype)


def test_bf16_never_takes_the_ffma_kernel():
    """The FFMA library has no bf16 entry point, and the wgmma library
    only a bf16 one: a bf16 tensor cannot reach the FFMA kernel."""
    assert set(_cuda._SIGNATURES["flash_attention"]) == {"flash_attention_f32"}
    assert set(_cuda._SIGNATURES["flash_attention_wgmma"]) == {
        "flash_attention_bf16"}
    assert "flash_attention_wgmma" in _cuda.SOURCES


@pytest.mark.parametrize("bq,bk", [(96, 128), (128, 32), (256, 128),
                                   (64, 0)])
def test_flash_attention_rejects_unserved_tiles(bq, bk):
    q = torch.zeros((1, 130, 4, 64), dtype=torch.bfloat16)
    k = torch.zeros((1, 130, 2, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="tiles"):
        flash_attention(q, k, k, bq=bq, bk=bk)


def test_tma_strides_of_contiguous_and_strided_inputs():
    """A contiguous (B, T, H, hd) and a (B, H, T, hd) storage read as
    (B, T, H, hd) both pass; a size-1 batch takes its dense stride."""
    q = torch.zeros((2, 100, 14, 64), dtype=torch.bfloat16)
    assert tma_strides(q.shape, q.stride(), 0) == q.stride()[:3]
    view = torch.zeros((2, 14, 100, 64)).transpose(1, 2)
    assert tma_strides(view.shape, view.stride(), 1024) == (14 * 100 * 64,
                                                            64, 100 * 64)
    one = torch.zeros((1, 100, 2, 64))[:, :, :1]       # stride 128 on H
    assert tma_strides(one.shape, (3, 128, 5, 1), 0) == (100 * 64, 128, 64)


@pytest.mark.parametrize("strides,ptr", [
    ((100 * 14 * 64, 14 * 64 + 4, 64), 0),   # a row stride of 8 bytes off
    ((100 * 14 * 64, 14 * 64, 68), 0),       # a head stride of 136 bytes
    ((100 * 14 * 64, 14 * 64, 64), 8),       # an address 8 bytes off
])
def test_tma_strides_reject_what_tma_cannot_read(strides, ptr):
    with pytest.raises(ValueError, match="16-byte"):
        tma_strides((2, 100, 14, 64), strides, ptr)


# -- K9's bf16 tolerance ------------------------------------------------------


def _head(seed, t=256, hd=64):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((t, hd), generator=gen)


def test_bf16_check_passes_an_exact_and_a_rounded_output():
    oracle = _head(0)
    library = oracle.bfloat16()
    for got in (oracle, oracle.bfloat16()):
        r = bf16_attention_check(got, oracle, library)
        assert r["ok"], r
    r = bf16_attention_check(oracle.bfloat16(), oracle, library)
    assert r["mean_err"] == r["library_mean_err"]
    assert r["max_limit"] == BF16_MAX_ERR * float(oracle.abs().max())


def test_bf16_check_fails_a_large_error_at_one_place():
    """One output off by just over 2 * 2^-8 of the largest |oracle| fails,
    however small the mean error; just under passes."""
    oracle = _head(1)
    library = oracle.bfloat16()
    scale = float(oracle.abs().max())
    for factor, ok in ((1.01, False), (0.99, True)):
        got = oracle.bfloat16().float()
        got[3, 5] = oracle[3, 5] + factor * BF16_MAX_ERR * scale
        r = bf16_attention_check(got, oracle, library)
        assert r["ok"] is ok, (factor, r)
        assert r["mean_err"] < r["mean_limit"]


def test_bf16_check_fails_a_mean_error_above_the_library():
    """An error spread everywhere, small at each place but with a mean
    over 1.5 x the library's, fails; at 1.4 x it passes."""
    oracle = _head(2)
    library = oracle.bfloat16()
    lib_mean = float((library.float() - oracle).abs().mean())
    for factor, ok in ((1.6, False), (1.4, True)):
        got = oracle + factor * lib_mean * torch.sign(_head(3))
        r = bf16_attention_check(got, oracle, library)
        assert r["max_err"] <= r["max_limit"]
        assert r["ok"] is ok, (factor, r)
    assert BF16_MEAN_VS_LIBRARY == 1.5


def test_bf16_check_fails_one_wrong_row():
    """A late row whose outputs are far below the head's largest, wrong
    by 5 bf16 steps of its own scale, passes the head's max and mean
    limits but fails the row limit; at 3 steps it passes."""
    oracle = _head(4)
    oracle[200] *= 0.05               # a row that averages many keys
    library = oracle.bfloat16()
    row_scale = float(oracle[200].abs().max())
    for steps, ok in ((5, False), (3, True)):
        got = oracle.bfloat16().float()
        got[200] = oracle[200] + steps * 2.0 ** -8 * row_scale * torch.sign(
            _head(5)[200])
        r = bf16_attention_check(got, oracle, library)
        assert r["max_err"] <= r["max_limit"]
        assert r["mean_err"] <= r["mean_limit"]
        assert r["ok"] is ok, (steps, r)
    assert BF16_ROW_ERR == 4 * 2.0 ** -8


# -- the build and the counters -----------------------------------------------


def test_source_flags_go_into_the_library_hash(monkeypatch):
    """The flags each source is built with name its library: a changed
    flag names a new library for every source, so each is rebuilt, and
    every library stays under the build directory."""
    before = {name: _cuda._lib_path(name) for name in _cuda.SOURCES}
    monkeypatch.setattr(_cuda, "NVCC_FLAGS", (*_cuda.NVCC_FLAGS, "-DEXTRA=1"))
    after = {name: _cuda._lib_path(name) for name in _cuda.SOURCES}
    assert all(after[n] != before[n] for n in _cuda.SOURCES)
    assert len(set(after.values())) == len(_cuda.SOURCES)
    assert "--warn-on-spills" in _cuda.NVCC_FLAGS
    assert all(_cuda.BUILD_DIR in path.parents for path in after.values())


def test_route_counts_reset_with_the_launches():
    saved = dict(LAUNCHES), {n: dict(r) for n, r in ROUTES.items()}
    try:
        reset_launches()
        _cuda.count("tiled_matmul", "small_k")
        _cuda.count("flash_attention", "wgmma")
        _cuda.count("hess_update")
        assert LAUNCHES["tiled_matmul"] == 1 and LAUNCHES["hess_update"] == 1
        assert ROUTES["tiled_matmul"] == {"tiled": 0, "small_n": 0,
                                          "small_k": 1}
        assert ROUTES["flash_attention"] == {"wgmma": 1, "ffma": 0}
        reset_launches()
        assert not any(LAUNCHES.values())
        assert not any(n for r in ROUTES.values() for n in r.values())
    finally:
        LAUNCHES.update(saved[0])
        for name, routes in saved[1].items():
            ROUTES[name].update(routes)
