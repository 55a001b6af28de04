"""The port's CUDA kernels against their plain PyTorch versions, on a
card. Without one every test here skips; on the card run

    python -m pytest -m cuda tests/test_torch_cuda.py

This file imports neither JAX nor the JAX package, so it runs where only
PyTorch is installed.
"""

import dataclasses

import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels import LAUNCHES, ROUTES, reset_launches
from repro_torch.kernels.adversarial import (
    SCATTER_CASES,
    SUM_CASES,
    TOPK_CASES,
    TWO_PASS_SHAPES,
    block_sparse_pairs,
    scatter_pairs,
    topk_inputs,
    two_pass_pairs,
)
from repro_torch.kernels.block_topk import (
    block_topk,
    block_topk_payload,
    diff_topk_payload,
)
from repro_torch.kernels.flash_attention import (
    bf16_attention_check,
    flash_attention,
    flash_attention_ref,
    gqa_flash_attention_ref,
)
from repro_torch.kernels.hess_update import hess_update, hess_update_ref
from repro_torch.kernels.scatter_accum import (
    block_scatter_accumulate,
    block_scatter_accumulate_ref,
    scatter_accumulate,
    scatter_accumulate_ref,
)
from repro_torch.kernels.scatter_accum import plan as scatter_plan
from repro_torch.kernels.tiled_matmul import (
    plan,
    subspace_iteration,
    subspace_iteration_ref,
    tiled_matmul,
    tiled_matmul_ref,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _sym(n, d, gen):
    m = torch.randn((n, d, d), generator=gen, dtype=torch.float64)
    return 0.5 * (m + m.transpose(1, 2))


def _pairs(n, k, numel, gen):
    idx = torch.randint(0, numel, (n, k), generator=gen)
    idx[:, 3] = idx[:, 1]
    idx[:, -5:] = -1
    return (torch.randn((n, k), generator=gen, dtype=torch.float64),
            idx.to(torch.int32))


@pytest.mark.parametrize("k,block", [(8, 128), (16384, 128), (40, 16)])
def test_diff_topk_payload_kernel_matches_plain(cuda, k, block):
    gen = torch.Generator().manual_seed(0)
    a, b = _sym(4, 300, gen), _sym(4, 300, gen)
    a[:, :6, :6] = 9.0                          # a tie cluster
    b[:, :6, :6] = 0.0
    got = diff_topk_payload(a.to(cuda), b.to(cuda), k=k, block=block)
    want = diff_topk_payload(a, b, k=k, block=block)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
    torch.testing.assert_close(got[2].cpu(), want[2], rtol=1e-12, atol=0)


@pytest.mark.parametrize("symmetric", [False, True])
def test_scatter_accumulate_kernel_matches_plain(cuda, symmetric):
    """Both add in stream order, so the sums agree bit for bit."""
    gen = torch.Generator().manual_seed(1)
    v, i = _pairs(6, 300, 300 * 300, gen)
    init = torch.randn((300, 300), generator=gen, dtype=torch.float64)
    for seed in (None, init):
        got = scatter_accumulate(v.to(cuda), i.to(cuda), (300, 300),
                                 symmetric=symmetric,
                                 init=None if seed is None else seed.to(cuda))
        want = scatter_accumulate_ref(v, i, (300, 300), symmetric=symmetric,
                                      init=seed)
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", SCATTER_CASES)
def test_scatter_accumulate_matches_plain_on_adversarial_pairs(cuda, case,
                                                              dtype):
    """K2 against its plain version on the CPU, bit for bit: every pair
    on one cell, the diagonal (symmetric), all padding, indices past the
    matrix, a ragged n * k, a (1, 90,000) row, mirrors outside a 30 x 70
    matrix, -0.0 init and values, a silo scaled by 0 (which equals the
    silo left out), 142 silos on the same hot cells."""
    args = scatter_pairs(case, dtype, seed=23)
    silo = args.pop("zero_silo", None)
    on_card = {**args, "values": args["values"].to(cuda),
               "indices": args["indices"].to(cuda),
               "init": None if args["init"] is None else args["init"].to(cuda)}
    got = scatter_accumulate(**on_card).cpu()
    want = scatter_accumulate_ref(**args)
    bits = torch.int64 if dtype == torch.float64 else torch.int32
    assert torch.equal(got.view(bits), want.view(bits))
    if silo is not None:
        dropped = on_card["indices"].clone()
        dropped[silo] = -1
        alone = scatter_accumulate(**{**on_card, "indices": dropped}).cpu()
        assert torch.equal(alone.view(bits), got.view(bits))


@pytest.mark.parametrize("n,k,d,symmetric", [
    (142, 300, 300, False), (142, 300, 300, True), (16, 4096, 1100, False),
    (142, 2048, 2048, False), (2, 10, 10, True)])
def test_scatter_accumulate_kernel_matches_plain_at_path_shapes(
        cuda, n, k, d, symmetric):
    """w8a's Top-K (plain and symmetric), d = 1,100, the K3 shape (d =
    2,048 f64, k = d) and a matrix of one region (a sort of 2 digits),
    bit for bit against the CPU plain version."""
    gen = torch.Generator().manual_seed(8)
    v, i = _pairs(n, k, d * d, gen)
    hot = torch.randint(0, d * d, (64,), generator=gen).to(torch.int32)
    i[:, ::4] = hot[torch.randint(0, 64, (n, (k + 3) // 4), generator=gen)]
    got = scatter_accumulate(v.to(cuda), i.to(cuda), (d, d),
                             symmetric=symmetric)
    assert torch.equal(got.cpu(), scatter_accumulate_ref(v, i, (d, d),
                                                         symmetric=symmetric))


@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("which", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_scatter_accumulate_two_pass_sort_matches_plain(cuda, dtype, which,
                                                        symmetric):
    """Over 2,047 regions (a flat row and a square per dtype), where the
    sort takes two passes and each sum warp searches for its bucket;
    init when symmetric. Bit for bit against the CPU plain version."""
    shape = TWO_PASS_SHAPES[dtype][which]
    args = two_pass_pairs(shape, symmetric, dtype, seed=26)
    n, k = args["values"].shape
    assert scatter_plan(n, k, *shape, symmetric,
                        args["values"].element_size()).passes == 2
    got = scatter_accumulate(**{**args, "values": args["values"].to(cuda),
                                "indices": args["indices"].to(cuda),
                                "init": None if args["init"] is None
                                else args["init"].to(cuda)}).cpu()
    bits = torch.int64 if dtype == torch.float64 else torch.int32
    assert torch.equal(got.view(bits),
                       scatter_accumulate_ref(**args).view(bits))


def test_block_scatter_accumulate_kernel_matches_plain(cuda):
    gen = torch.Generator().manual_seed(2)
    v, i = _pairs(4 * 9, 48, 128 * 128, gen)
    v, i = v.reshape(4, 9, 48), i.reshape(4, 9, 48)
    got = block_scatter_accumulate(v.to(cuda), i.to(cuda), (3, 3), 128)
    want = block_scatter_accumulate_ref(v, i, (3, 3), 128)
    assert torch.equal(got.cpu(), want)


def _cohort_round_weights(n, d, dtype, device, seed):
    """(n,) weights of a ``fednl-cohort`` round on w8a (K = 28 of n, the
    fl-cross-device deadline at 0.8, beta = 0.5) from the port's own
    ``round_weights``: 0 for the unsampled, 1 on time, (1 + s)^(-1/2)
    for a straggler s rounds stale."""
    from repro_torch.core import CohortFedNLPP, CohortSpec, TopK
    from repro_torch.core.cohort import CohortFedNLPPState
    from repro_torch.engine.method import RoundDraws

    co = CohortFedNLPP(None, None, TopK(d), CohortSpec(cohort=28))
    gen = torch.Generator().manual_seed(seed)
    state = CohortFedNLPPState(
        w=torch.zeros(n, d, dtype=dtype, device=device), h_local=None,
        l_local=None, g_local=None, h_global=None, l_global=None,
        g_global=None, x=torch.zeros(d, dtype=dtype, device=device), step=9,
        draws=None, last_round=torch.randint(0, 9, (n,), generator=gen,
                                             dtype=torch.int32).to(device))
    active = RoundDraws(seed, device).active(n, 28)
    return co.round_weights(state, active)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cohort_round_weighted_payloads_match_plain(cuda, dtype):
    """K2 and K4 on a w8a cohort round's fractionally weighted payloads
    (142 silos, Top-K k = 300 pairs and Block-Top-K 8 of 128^2 tiles),
    bit for bit against their plain versions on the CPU."""
    w = _cohort_round_weights(142, 300, dtype, cuda, seed=11)
    assert ((w > 0) & (w < 1)).any() and (w == 1).any() and (w == 0).any()
    gen = torch.Generator().manual_seed(12)
    v, i = _pairs(142, 300, 300 * 300, gen)
    v = (v.to(dtype).to(cuda) * w[:, None]).contiguous()
    got = scatter_accumulate(v, i.to(cuda), (300, 300)).cpu()
    bits = torch.int64 if dtype == torch.float64 else torch.int32
    want = scatter_accumulate_ref(v.cpu(), i, (300, 300))
    assert torch.equal(got.view(bits), want.view(bits))
    bv, bi = _pairs(142 * 9, 8, 128 * 128, gen)
    bv = (bv.to(dtype).reshape(142, 9, 8).to(cuda)
          * w[:, None, None]).contiguous()
    bi = bi.reshape(142, 9, 8)
    got = block_scatter_accumulate(bv, bi.to(cuda), (3, 3), 128).cpu()
    want = block_scatter_accumulate_ref(bv.cpu(), bi, (3, 3), 128)
    assert torch.equal(got.view(bits), want.view(bits))


def test_wrappers_count_launches_and_reject_bad_input(cuda):
    reset_launches()
    v, i = _pairs(2, 10, 100, torch.Generator().manual_seed(3))
    scatter_accumulate(v.to(cuda), i.to(cuda), (10, 10))
    assert LAUNCHES == {"diff_topk_payload": 0, "scatter_accumulate": 1,
                        "block_scatter_accumulate": 0,
                        "block_topk_payload": 0, "block_topk": 0,
                        "hess_update": 0, "tiled_matmul": 0,
                        "flash_attention": 0}
    with pytest.raises(TypeError, match="int32"):
        scatter_accumulate(v.to(cuda), i.to(cuda).long(), (10, 10))
    with pytest.raises(ValueError, match="one CUDA device"):
        scatter_accumulate(v.to(cuda), i, (10, 10))
    assert LAUNCHES["scatter_accumulate"] == 1


def test_diff_topk_payload_shared_b_matches_plain(cuda):
    """One b for every silo (stride 0) equals the stacked copy."""
    gen = torch.Generator().manual_seed(4)
    a = torch.randn((4, 200, 300), generator=gen, dtype=torch.float32)
    b = torch.randn((200, 300), generator=gen, dtype=torch.float32)
    got = diff_topk_payload(a.to(cuda), b.to(cuda), k=100, block=64)
    full = diff_topk_payload(a.to(cuda), b.expand(4, -1, -1).contiguous()
                             .to(cuda), k=100, block=64)
    want = diff_topk_payload(a, b, k=100, block=64)
    for g, f, w in zip(got[:2], full[:2], want[:2]):
        assert torch.equal(g.cpu(), w) and torch.equal(f.cpu(), w)
    torch.testing.assert_close(got[2].cpu(), want[2], rtol=1e-5, atol=0)


@pytest.mark.parametrize("k,block,bisect_all", [
    (8, 128, False), (16384, 128, False), (64, 8, True), (40, 16, False)])
def test_block_topk_payload_kernel_matches_plain(cuda, k, block, bisect_all):
    gen = torch.Generator().manual_seed(5)
    x = _sym(3, 300, gen)
    x[:, :6, :6] = 9.0                          # a tie cluster
    x[:, 200:, :] = 0.0                         # tiles with few nonzeros
    for t in (x, x.float()):
        got = block_topk_payload(t.to(cuda), k, block, bisect_all=bisect_all)
        want = block_topk_payload(t, k, block, bisect_all=bisect_all)
        assert torch.equal(got[0].cpu(), want[0])
        assert torch.equal(got[1].cpu(), want[1])


@pytest.mark.parametrize("k,block", [(8, 128), (16384, 128), (40, 16)])
def test_block_topk_kernel_matches_plain(cuda, k, block):
    gen = torch.Generator().manual_seed(6)
    x = _sym(2, 300, gen)
    x[:, :6, :6] = -9.0
    for t in (x, x.float()):
        assert torch.equal(block_topk(t.to(cuda), k, block).cpu(),
                           block_topk(t, k, block))


# (block, k, rows, cols): the path's block 128 and k 2048 on a ragged
# grid; k = 8000, where v falls in a digit crowded by ties or zeros (the
# select's path over every entry); k >= block^2; block 8 on rows of 301
# (no 16-byte loads); block 12
TOPK_SHAPES = [(128, 2048, 300, 260), (128, 8000, 300, 260),
               (128, 16384, 200, 132), (8, 5, 37, 301), (12, 50, 61, 48)]


@pytest.mark.parametrize("shape", TOPK_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", TOPK_CASES)
def test_block_topk_kernels_match_plain_on_adversarial_tiles(cuda, case,
                                                            dtype, shape):
    """K1 (one b shared by the silos and a stacked b), K5 (with and
    without ``bisect_all``) and K6 on tiles of zeros, heavy ties, -0.0,
    inf and ragged edges: payloads, indices and dense tiles bit for bit,
    ||D||^2 to 1e-5 (f32) or 1e-12 (f64) relative."""
    block, k, m, cols = shape
    a, b = topk_inputs(case, 4, m, cols, dtype, seed=21)
    a_c, b_c = a.to(cuda), b.to(cuda)
    want = diff_topk_payload(a, b, k=k, block=block)
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    for bb in (b_c, b_c.expand_as(a_c).contiguous()):
        got = diff_topk_payload(a_c, bb, k=k, block=block)
        assert torch.equal(got[0].cpu(), want[0])
        assert torch.equal(got[1].cpu(), want[1])
        torch.testing.assert_close(got[2].cpu(), want[2], rtol=tol, atol=0)
    d = a - b
    for bisect_all in (False, True):
        got = block_topk_payload(d.to(cuda), k, block, bisect_all=bisect_all)
        want = block_topk_payload(d, k, block, bisect_all=bisect_all)
        assert torch.equal(got[0].cpu(), want[0])
        assert torch.equal(got[1].cpu(), want[1])
    assert torch.equal(block_topk(d.to(cuda), k, block).cpu(),
                       block_topk(d, k, block))


# (block, silos, k, grid): the path's shapes, one silo, block 8, a block
# whose tile exceeds shared memory (row bands; k above one chunk of
# slots), and k not a multiple of 4 (no 16-byte loads)
SUM_SHAPES = [(128, 4, 2048, (3, 2)), (128, 1, 2048, (2, 3)),
              (8, 4, 20, (5, 3)), (256, 4, 3000, (2, 1)),
              (128, 4, 37, (1, 2))]


@pytest.mark.parametrize("shape", SUM_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", SUM_CASES)
def test_block_scatter_accumulate_matches_plain_on_adversarial_pairs(
        cuda, case, dtype, shape):
    """K4 against its plain version on the CPU (whose index_add_ adds in
    stream order), bit for bit: distinct cells, cells repeated within a
    silo, every silo on the same cells with -0.0 and 0 values; all with
    -1 padding and out-of-range indices, on ragged grids."""
    block, n, k, grid = shape
    vals, idx = block_sparse_pairs(case, n, grid[0] * grid[1], k, block,
                                   dtype, seed=22)
    got = block_scatter_accumulate(vals.to(cuda), idx.to(cuda), grid, block)
    want = block_scatter_accumulate_ref(vals, idx, grid, block)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_hess_update_kernel_matches_plain(cuda, dtype):
    """H + alpha * S bit for bit (one fused multiply-add on both sides),
    the f32 norm to 1e-6."""
    gen = torch.Generator().manual_seed(7)
    h, d, s = (torch.randn((5, 300, 123), generator=gen, dtype=dtype)
               for _ in range(3))
    got = hess_update(h.to(cuda), d.to(cuda), s.to(cuda), 0.37)
    want = hess_update_ref(h, d, s, 0.37)
    assert torch.equal(got[0].cpu(), want[0])
    torch.testing.assert_close(got[1].cpu(), want[1], rtol=1e-6, atol=0)


def test_tiled_matmul_kernel_matches_plain(cuda):
    """f32 products, f32 sums, no TF32: 1e-5 of the largest entry."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(8)
    m = torch.randn((300, 500), generator=gen, dtype=torch.float64)
    q = torch.linalg.qr(torch.randn((500, 2), generator=gen,
                                    dtype=torch.float32))[0]
    for a, b in ((m, m.T), (m.float(), q), (m.float().T, m[:, :7].float())):
        got = tiled_matmul(a.to(cuda), b.to(cuda)).cpu()
        want = tiled_matmul_ref(a.to(cuda), b.to(cuda)).cpu()
        assert got.dtype == a.dtype
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    got = subspace_iteration(m.to(cuda), q.to(cuda)).cpu()
    want = subspace_iteration_ref(m.to(cuda), q.to(cuda)).cpu()
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("name,route", [
    ("a", "small_n"), ("b", "small_n"), ("c", "small_k"), ("a1", "small_n"),
    ("b1", "small_n"), ("odd_rows", "tiled"), ("odd_cols", "tiled"),
    ("odd_k", "tiled"), ("square", "tiled")])
def test_tiled_matmul_routes_match_plain(cuda, name, route):
    """The power iteration's products on qwen2's wg[0] (896 x 4864, f32),
    and skinny shapes that allow no 16-byte access (so they are tiled),
    each to 1e-5 of the largest entry, counted under its route."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(14)
    m = torch.randn((896, 4864), generator=gen).to(cuda)
    q = torch.linalg.qr(torch.randn((4864, 2), generator=gen))[0].to(cuda)
    p = torch.linalg.qr(torch.randn((896, 2), generator=gen))[0].to(cuda)
    a, b = {"a": (m, q), "b": (m.T, p), "c": (p, q.T),
            "a1": (m, q[:, :1]), "b1": (m.T, p[:, :1]),
            "odd_rows": (m[:299, :301], m[:301, :3]),
            "odd_cols": (m[:301, :299].T, m[:301, :5]),
            "odd_k": (m[:299, :3], m[:3, :301]),
            "square": (m.T, m[:, :896])}[name]
    assert plan(a.shape[0], b.shape[1], a.shape[1], a.stride(),
                a.data_ptr() % 16 == 0).route == route
    reset_launches()
    got = tiled_matmul(a, b)
    want = tiled_matmul_ref(a, b)
    assert ROUTES["tiled_matmul"][route] == 1 == LAUNCHES["tiled_matmul"]
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def _attention_inputs(b, t, h, kv, hd, seed):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn((b, t, h, hd), generator=gen),
            torch.randn((b, t, kv, hd), generator=gen),
            torch.randn((b, t, kv, hd), generator=gen))


@pytest.mark.parametrize("shape,tiles", [
    ((2, 384, 4, 4, 64), (128, 128)),      # multiple of the tiles, MHA
    ((1, 1000, 14, 2, 64), (128, 128)),    # ragged T, qwen2's GQA
    ((1, 1000, 14, 2, 64), (128, 64)),     # bq > bk: every key still seen
    ((1, 1000, 14, 2, 64), (64, 128)),
    ((2, 300, 4, 2, 128), (128, 128)),     # hd 128
    ((2, 300, 4, 2, 128), (64, 64)),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(cuda, shape, tiles, dtype):
    """f32 (the FFMA kernel) to 1e-5 of the plain version (both sum in
    f32, in other orders); bf16 (the wgmma kernel, P rounded to bf16) to
    the f32 oracle head by head, within ``bf16_attention_check``'s
    limits beside SDPA."""
    q, k, v = (x.to(cuda, dtype) for x in _attention_inputs(*shape, seed=9))
    got = flash_attention(q, k, v, *tiles)
    if dtype == torch.float32:
        want = gqa_flash_attention_ref(q, k, v)
        assert float((got - want).abs().max()) <= 1e-5
    else:
        _assert_bf16_close(got, q, k, v)


def _sdpa_head(q, k, v, window=None):
    if window is None:
        return F.scaled_dot_product_attention(
            q[None, None], k[None, None], v[None, None], is_causal=True)[0, 0]
    i = torch.arange(q.shape[0], device=q.device)
    mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
    return F.scaled_dot_product_attention(q[None, None], k[None, None],
                                          v[None, None], attn_mask=mask)[0, 0]


def _assert_bf16_close(got, q, k, v, window=None):
    n_rep = q.shape[2] // k.shape[2]
    for b in range(q.shape[0]):
        for h in range(q.shape[2]):
            qh, kh, vh = q[b, :, h], k[b, :, h // n_rep], v[b, :, h // n_rep]
            oracle = flash_attention_ref(qh[None].float(), kh[None].float(),
                                         vh[None].float(), window)[0]
            r = bf16_attention_check(got[b, :, h], oracle,
                                     _sdpa_head(qh, kh, vh, window))
            assert r["ok"], (b, h, r)


@pytest.mark.parametrize("shape", [
    (1, 200, 6, 1, 64),       # ragged T, 6 heads on one KV head
    (1, 4000, 14, 2, 64),     # ragged T, qwen2's GQA
    (2, 300, 4, 2, 128),      # hd 128: two 64-column boxes a row
    (1, 200, 6, 1, 128),
])
@pytest.mark.parametrize("tiles", [(128, 128), (128, 64), (64, 128),
                                   (64, 64)])
def test_flash_attention_bf16_wgmma_matches_oracle(cuda, shape, tiles):
    """Every served (hd, bq, bk) on the tensor-core route, counted as such."""
    q, k, v = (x.to(cuda, torch.bfloat16)
               for x in _attention_inputs(*shape, seed=12))
    reset_launches()
    got = flash_attention(q, k, v, *tiles)
    assert ROUTES["flash_attention"] == {"wgmma": 1, "ffma": 0}
    _assert_bf16_close(got, q, k, v)


@pytest.mark.parametrize("window", [1, 16, 100, 300])
@pytest.mark.parametrize("shape", [
    (1, 1000, 14, 2, 64),     # ragged T, qwen2's GQA
    (2, 700, 4, 2, 128),      # hd 128, starcoder2's head dim
])
@pytest.mark.parametrize("tiles", [(128, 128), (128, 64), (64, 128),
                                   (64, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_windowed_kernel_matches_plain(cuda, dtype, tiles,
                                                       shape, window):
    """Both kernels with a sliding window through the existing entry
    points and routes: f32 to 1e-5 of the windowed plain version, bf16 to
    the windowed f32 oracle beside SDPA with the window mask. Windows of
    100 and 300 start mid-tile, so the FFMA kernel's first tile is all
    masked for some rows; a window of 1 keeps only the diagonal."""
    q, k, v = (x.to(cuda, dtype) for x in _attention_inputs(*shape, seed=14))
    reset_launches()
    got = flash_attention(q, k, v, *tiles, window=window)
    route = "ffma" if dtype == torch.float32 else "wgmma"
    assert ROUTES["flash_attention"][route] == 1 == LAUNCHES["flash_attention"]
    if dtype == torch.float32:
        want = gqa_flash_attention_ref(q, k, v, window)
        assert float((got - want).abs().max()) <= 1e-5
    else:
        _assert_bf16_close(got, q, k, v, window)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_window_as_wide_as_t_is_causal(cuda, dtype):
    """A window of T or more walks every key tile the causal call walks:
    the same output bit for bit."""
    q, k, v = (x.to(cuda, dtype)
               for x in _attention_inputs(1, 600, 4, 2, 128, seed=15))
    causal = flash_attention(q, k, v)
    for window in (600, 4096):
        assert torch.equal(flash_attention(q, k, v, window=window), causal)


def test_windowed_prefill_launches_the_wgmma_kernel(cuda):
    """The reduced starcoder2 (window 16) in bf16 past the K9 branch runs
    the wgmma kernel once per layer, with the window, equal to the plain
    forward on the same weights within the bf16 tolerance of the logits."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config("starcoder2-3b", smoke=True),
                              dtype="bfloat16")
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device=cuda).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (1, 640), device=cuda)
    reset_launches()
    logits = make_prefill(model)(params, {"tokens": tokens})
    assert ROUTES["flash_attention"] == {"wgmma": cfg.n_layers, "ffma": 0}
    cpu = make_prefill(model)(_to_cpu(params), {"tokens": tokens.cpu()})
    gap = float((logits.float().cpu() - cpu.float()).abs().max())
    assert gap <= 8 * 2.0 ** -7 * float(cpu.float().abs().max())


def _to_cpu(tree):
    from repro_torch.tree import tree_map

    return tree_map(lambda a: a.cpu(), tree)


def test_flash_attention_bf16_reads_strided_inputs(cuda):
    """bf16 q, k, v as (B, T, H, hd) views of (B, H, T, hd) storage: TMA
    reads them in place, equal to the contiguous call bit for bit."""
    q, k, v = (x.to(cuda, torch.bfloat16)
               for x in _attention_inputs(2, 700, 4, 2, 128, seed=13))
    views = [x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v)]
    assert not views[0].is_contiguous()
    assert torch.equal(flash_attention(*views), flash_attention(q, k, v))


def test_prefill_launches_the_wgmma_kernel(cuda):
    """A bf16 forward past the K9 branch (T > 512) runs the wgmma symbol
    once per layer and the FFMA symbol never, by the counters and by the
    profile."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config("qwen2-0.5b", smoke=True),
                              dtype="bfloat16")
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device=cuda).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (1, 640), device=cuda)
    reset_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        logits = make_prefill(model)(params, {"tokens": tokens})
        torch.cuda.synchronize()
    assert bool(torch.isfinite(logits.float()).all())
    assert ROUTES["flash_attention"] == {"wgmma": cfg.n_layers, "ffma": 0}
    names = [e.key for e in prof.key_averages()]
    assert sum(e.count for e in prof.key_averages()
               if "flash_attention_kernel_wgmma" in e.key) == cfg.n_layers
    assert not any("flash_attention_kernel<" in n for n in names)


def test_flash_attention_kernel_reads_strided_inputs(cuda):
    """q, k, v as (B, T, H, hd) views of (B, H, T, hd) storage equal the
    contiguous call bit for bit."""
    q, k, v = (x.to(cuda) for x in _attention_inputs(2, 700, 4, 2, 64, seed=10))
    views = [x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v)]
    assert not views[0].is_contiguous()
    assert torch.equal(flash_attention(*views), flash_attention(q, k, v))


def test_flash_attention_counts_launches_and_rejects_bad_input(cuda):
    q, k, v = (x.to(cuda) for x in _attention_inputs(1, 600, 4, 2, 64, seed=11))
    reset_launches()
    flash_attention(q, k, v)
    assert LAUNCHES["flash_attention"] == 1
    assert sum(LAUNCHES.values()) == 1
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention(q.clone().requires_grad_(), k, v)
    with pytest.raises(TypeError, match="bf16 or f32"):
        flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q[..., :32], k[..., :32], v[..., :32])
    with pytest.raises(ValueError, match="one CUDA device"):
        flash_attention(q, k.cpu(), v)
    assert LAUNCHES["flash_attention"] == 1


# -- the MoE, encoder-decoder, VLM, hybrid and ssm families --------------------------------------


@pytest.mark.parametrize("shape", [
    (1, 700, 6, 6, 64),       # whisper-tiny: no GQA at all (n_rep 1)
    (1, 700, 16, 8, 64),      # granite-moe-1b-a400m: n_rep 2
    (1, 700, 48, 8, 128),     # grok-1-314b: n_rep 6
    (1, 700, 56, 8, 128),     # llava-next-34b: n_rep 7
    (1, 700, 64, 8, 128),     # jamba-1.5-large-398b: n_rep 8
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_at_the_new_gqa_shapes(cuda, dtype, shape):
    """K9 at the head counts of the five models (ragged T): f32 to 1e-5
    of ``flash_attention_ref`` head by head, bf16 to the f32 oracle
    within ``bf16_attention_check``'s limits; one launch by the route."""
    q, k, v = (x.to(cuda, dtype) for x in _attention_inputs(*shape, seed=21))
    reset_launches()
    got = flash_attention(q, k, v)
    route = "ffma" if dtype == torch.float32 else "wgmma"
    assert ROUTES["flash_attention"][route] == 1 == LAUNCHES["flash_attention"]
    if dtype == torch.float32:
        n_rep = shape[2] // shape[3]
        for h in range(shape[2]):
            want = flash_attention_ref(q[:, :, h], k[:, :, h // n_rep],
                                       v[:, :, h // n_rep])
            assert float((got[:, :, h] - want).abs().max()) <= 1e-5, h
    else:
        _assert_bf16_close(got, q, k, v)


@pytest.mark.parametrize("width", ["reduced", "granite"])
def test_moe_routing_on_card_matches_cpu(cuda, width):
    """``_route`` on the card against the CPU on the same f32 logits
    (dispatch exact, combine and aux to 1e-6), and ``moe_forward`` of
    reduced granite in f32 to 1e-5 of the largest output."""
    from repro_torch.configs import get_config
    from repro_torch.models import mlp

    cfg = get_config("granite-moe-1b-a400m", smoke=width == "reduced")
    gen = torch.Generator().manual_seed(5)
    g, e = cfg.moe.group_size, cfg.moe.num_experts
    logits = torch.randn((6, g, e), generator=gen)
    d, c, a = mlp._route(logits, cfg)
    dc, cc, ac = (x.cpu() for x in mlp._route(logits.to(cuda), cfg))
    assert torch.equal(dc, d)
    assert float((cc - c).abs().max()) <= 1e-6
    assert float((ac - a).abs().max()) <= 1e-6
    if width != "reduced":
        return
    p = mlp.moe_init(torch.Generator().manual_seed(6), cfg)
    x = torch.randn((3, 50, cfg.d_model), generator=gen)
    y, aux = mlp.moe_forward(p, x, cfg)
    yc, auxc = mlp.moe_forward(_to(p, cuda), x.to(cuda), cfg)
    assert float((yc.cpu() - y).abs().max()) <= 1e-5 * float(y.abs().max())
    assert abs(float(auxc) - float(aux)) <= 1e-6


def _to(tree, dev):
    from repro_torch.tree import tree_map

    return tree_map(lambda a: a.to(dev), tree)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "grok-1-314b",
                                  "whisper-tiny", "llava-next-34b"])
def test_new_family_prefill_runs_k9_and_matches_cpu(cuda, arch):
    """Each reduced model's prefill at T = 640 (llava: 16 patches and 624
    tokens; whisper: 32 frames) in f32 launches K9's FFMA kernel once per
    decoder layer and equals the CPU port to 1e-4 of the largest logit;
    in bf16 (whisper and llava, whose routes do not depend on rounding)
    the wgmma kernel, within 8 bf16 steps of the CPU's logits."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill
    from repro_torch.launch.train import add_modality_inputs
    from repro_torch.models import build_model

    dtypes = (["float32"] if get_config(arch).moe is not None
              else ["float32", "bfloat16"])
    for dtype in dtypes:
        cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype)
        model = build_model(cfg)
        params = model.init_params(torch.Generator().manual_seed(0))
        t = 640 - cfg.vision_tokens
        batch = add_modality_inputs({"tokens": torch.randint(
            0, cfg.vocab, (1, t), generator=torch.Generator().manual_seed(1))},
            cfg, 0)
        cpu = make_prefill(model)(params, batch)
        reset_launches()
        got = make_prefill(model)(_to(params, cuda), _to(batch, cuda))
        route = "ffma" if dtype == "float32" else "wgmma"
        assert ROUTES["flash_attention"][route] == cfg.n_layers
        assert LAUNCHES["flash_attention"] == cfg.n_layers
        gap = float((got.float().cpu() - cpu.float()).abs().max())
        scale = float(cpu.float().abs().max())
        assert gap <= (1e-4 if dtype == "float32" else 8 * 2.0 ** -7) * scale


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "xlstm-350m"])
def test_hybrid_and_ssm_prefill_and_decode_match_cpu(cuda, arch):
    """Each reduced model in f32 (jamba with two segments, so two
    attention layers) on the card against the CPU port, to 1e-4 of the
    largest logit: the prefill at T = 640 (jamba: K9's FFMA kernel once
    per attention layer; xlstm: none) and 20 decode steps, whose
    recurrent states are written into the stacked caches in place."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill, make_serve_step
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config(arch, smoke=True), n_layers=4)
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (2, 640),
                         generator=torch.Generator().manual_seed(1))
    cpu = make_prefill(model)(params, {"tokens": toks})
    card_params = _to(params, cuda)
    reset_launches()
    got = make_prefill(model)(card_params, {"tokens": toks.to(cuda)})
    attn_layers = sum(m == "attn" for m, _ in model.kinds) * model.n_segments
    assert LAUNCHES["flash_attention"] == attn_layers == ROUTES[
        "flash_attention"]["ffma"]
    assert attn_layers == (2 if arch == "jamba-1.5-large-398b" else 0)
    scale = float(cpu.abs().max())
    assert float((got.cpu() - cpu).abs().max()) <= 1e-4 * scale
    serve = make_serve_step(model)
    caches = {"cpu": model.init_cache(2, 20, "cpu"),
              "card": model.init_cache(2, 20, cuda)}
    for pos in range(20):
        want, caches["cpu"] = serve(params, caches["cpu"],
                                    toks[:, pos:pos + 1], pos)
        lg, caches["card"] = serve(card_params, caches["card"],
                                   toks[:, pos:pos + 1].to(cuda), pos)
        gap = float((lg.cpu() - want).abs().max())
        assert gap <= 1e-4 * float(want.abs().max()), pos


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "xlstm-350m"])
def test_hybrid_and_ssm_fednl_train_steps_match_cpu(cuda, arch):
    """3 fednl steps of each reduced model in f32 (B = 4, T = 300, so the
    Mamba scan runs two checkpointed chunks; 2 microbatches, 2 silos, a
    refresh every 2 steps, exact Block-Top-K) on the card against the CPU
    port: every parameter leaf within 1e-4 of its largest |value|, and
    every curvature leaf too, but xlstm's within 1e-3: f32 rounding alone
    moves its H by 1.6e-4 of a leaf's largest at this shape (one f32 step
    of noise on the weights, ``scripts/train_rounding_floor.py``); K1 and
    K4 launched on the refresh steps alone, no K9."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_optimizer, make_train_step
    from repro_torch.models import build_model
    from repro_torch.tree import tree_leaves

    cfg = get_config(arch, smoke=True)
    model = build_model(cfg, use_remat=True)
    params = model.init_params(torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (3, 4, 300),
                         generator=torch.Generator().manual_seed(1))
    out = {}
    for dev in ("cpu", cuda):
        opt = make_optimizer("fednl", 1e-2, k_per_block=64, block=8)
        step = make_train_step(model, opt, microbatches=2, refresh_every=2,
                               n_silos=2)
        p = _to(params, dev)
        state = opt.init(p)
        for i in range(3):
            batch = {"tokens": toks[i].to(dev),
                     "targets": toks[i].roll(-1, dims=1).to(dev)}
            reset_launches()
            p, state, m = step(p, state, batch)
            if dev != "cpu":
                refreshed = m["curv_refreshed"] == 1.0
                assert refreshed == (i % 2 == 0)
                assert (LAUNCHES["diff_topk_payload"] > 0) == refreshed
                assert (LAUNCHES["block_scatter_accumulate"] > 0) == refreshed
                assert LAUNCHES["flash_attention"] == 0
        out[str(dev)] = {"params": [t.cpu() for t in tree_leaves(p)],
                         "h": [t.cpu() for t in tree_leaves(state.h)]}
    h_tol = 1e-3 if arch == "xlstm-350m" else 1e-4
    for name, tol in (("params", 1e-4), ("h", h_tol)):
        for i, (got, want) in enumerate(zip(out[str(cuda)][name],
                                            out["cpu"][name])):
            rel = float((got - want).abs().max()) / max(
                float(want.abs().max()), 1e-30)
            assert rel <= tol, (name, i, tuple(want.shape), rel)


def test_ssm_scan_backward_on_card_matches_cpu(cuda):
    """The Mamba scan's gradient at T = 300 (two chunks of 256, padded) on
    the card against the CPU port's, f32, within 1e-5 of each largest
    |grad|; the card's no-grad output equals its grad path's bit for
    bit."""
    from repro_torch.models import mamba

    gen = torch.Generator().manual_seed(3)
    t, di, s = 300, 24, 16
    args = [torch.randn((2, t, di), generator=gen),
            0.1 * torch.rand((2, t, di), generator=gen) + 1e-3,
            torch.randn((2, t, s), generator=gen),
            torch.randn((2, t, s), generator=gen),
            -torch.arange(1, s + 1, dtype=torch.float32)[None].repeat(di, 1)]
    w = torch.randn((2, t, di), generator=gen)
    grads = {}
    for dev in ("cpu", cuda):
        leaves = [a.detach().to(dev).requires_grad_(True) for a in args]
        y = mamba._ssm_scan(*leaves)
        (y * w.to(dev)).sum().backward()
        grads[str(dev)] = [a.grad.cpu() for a in leaves]
        if dev != "cpu":
            with torch.no_grad():
                assert torch.equal(mamba._ssm_scan(*[a.to(dev) for a in args]),
                                   y.detach())
    for got, want in zip(grads[str(cuda)], grads["cpu"]):
        assert float((got - want).abs().max()) <= 1e-5 * float(
            want.abs().max())


# -- the autotuner's dispatch and the launch query (phase 13's checks) --------


@pytest.fixture
def fresh_tuning_cache():
    from repro_torch.kernels.tuning import TuningCache, set_cache

    set_cache(TuningCache())
    yield
    set_cache(None)


def test_launch_query_matches_launch_resources(cuda):
    """Every kernel function's registers, static shared bytes and threads,
    and its launcher's dynamic shared bytes at a payload width, a digit
    width, a sum width and a block, as the card reports them, equal
    ``launch_resources``' pricing, each within a block's budget."""
    from repro_torch.kernels.resources import KERNELS

    import chip_smoke

    seen = {}
    for source, names in KERNELS.items():
        for kernel in names:
            for arg in chip_smoke.query_args(source, kernel)[:3]:
                chip_smoke.launch_matches(
                    chip_smoke._launch_of(source, kernel, arg), seen)
    assert len(seen) > 54 and all(q["registers"] > 0 for q in seen.values())


def test_tuned_dispatch_is_bit_for_bit(cuda, fresh_tuning_cache):
    """With a winner cached for the operand's card, a call with no config
    launches it (the resolver and the launch counter) and equals the plain
    version: K2 bit for bit on CPU copies, K7's H bit for bit."""
    from repro_torch.kernels.hess_update import resolve_block
    from repro_torch.kernels.scatter_accum import resolve_plan
    from repro_torch.kernels.tuning import KernelConfig, record

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    vals = torch.randn((20, 300), generator=g, device=dev,
                       dtype=torch.float64)
    idx = torch.randint(-1, 300 * 300, (20, 300), generator=g, device=dev,
                        dtype=torch.int32)
    cfg = KernelConfig(log_r=6, digit_bits=6, seg=32)
    record("scatter_accumulate", cfg, shape=(300, 300), k=300, n=20,
           dtype=torch.float64, device=dev)
    p = resolve_plan(20, 300, 300, 300, False, torch.float64, dev)
    assert (p.log_r, p.digit_bits, p.seg) == (6, 6, 32)
    reset_launches()
    got = scatter_accumulate(vals, idx, (300, 300))
    torch.cuda.synchronize()
    assert LAUNCHES["scatter_accumulate"] == 1
    assert torch.equal(got.cpu(), scatter_accumulate_ref(
        vals.cpu(), idx.cpu(), (300, 300)))
    h, d, s = (torch.randn((4, 300, 300), generator=g, device=dev,
                           dtype=torch.float64) for _ in range(3))
    record("hess_update", KernelConfig(block=32), shape=(4, 300, 300),
           dtype=torch.float64, device=dev)
    assert resolve_block(h.shape, h.dtype, dev) == 32
    out, l = hess_update(h, d, s, 0.5)
    want = hess_update_ref(h, d, s, 0.5, 32)
    assert torch.equal(out, want[0])
    assert torch.allclose(l, want[1], rtol=1e-6, atol=0)
