"""The port's hybrid and ssm families (jamba-1.5-large-398b, xlstm-350m)
against the JAX package, on the CPU: the configs, ``param_shapes`` at
full size, the input shapes and ``skip_reason``, the sharding rules of
the new leaves, ``init_params``' tree and laws, the Mamba scan and
layer, the mLSTM chunkwise scan and layer, the sLSTM layer, and the
reduced models whole (two and four layers, so one and two segments of
the period; xlstm also without a feed-forward, as the full model):
forward, decode against the reference's decode loop, decode == forward,
greedy ``generate`` and the serve CLI on the CPU.

Inputs come from numpy seeds, weights from the reference's
``init_params(PRNGKey(0))`` (or its ``*_init(PRNGKey(3))`` for one
layer), carried across with ``params_from_numpy``. Tolerances: f32
within 1e-5 of the largest |output| for a scan, a layer, and each layer
of a whole model fed the same input on both sides; whole models' logits
within 1e-4 of the largest |logit|, as the port's other whole-model
tests: the two frameworks' f32 rounding (about 1.5e-6 of a layer's
largest output) grows along the stack, the mLSTM's normalizer
max(|n^T q|, exp(-m)) amplifying it (17-fold in the second segment of
the four-layer xlstm); bf16 within ``BF16_STEPS`` (4 bf16 steps) of the
largest |output|, as in ``_torch_lm``. The Mamba scan is a log-depth
scan in both packages, over other trees, so f32 agrees to rounding, not
bit for bit. Whole jamba is held in f32 only: its MoE layers' routes
flip on bf16 near-ties (``test_torch_moe``), so bf16 is held per layer.
"""

import dataclasses
import functools
import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_lm import (  # noqa: F401 (fixture)
    BF16_STEPS,
    as_np,
    batches,
    check_param_shapes_at_full_size,
    jax_decode,
    no_activation_sharder,
    tokens,
)
from _torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

from repro.configs import get_config as jax_get_config
from repro.launch import shapes as jax_shapes
from repro.launch import sharding as jax_sharding
from repro.models import mamba as jax_mamba
from repro.models import xlstm as jax_xlstm
from repro.models.transformer import build_model as jax_build_model
from repro_torch.configs import (
    ARCHS as PORT_ARCHS,
    get_config,
    jamba_1_5_large_398b,
    xlstm_350m,
)
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import LAUNCHES
from repro_torch.launch import serve, shapes, sharding
from repro_torch.launch.serve import generate
from repro_torch.launch.steps import make_prefill, make_serve_step
from repro_torch.models import build_model, mamba, xlstm
from repro_torch.models.transformer import layer_kinds, period_len
from repro_torch.tree import tree_leaves, tree_map

pytestmark = pytest.mark.usefixtures("no_activation_sharder")

JAMBA, XLSTM = "jamba-1.5-large-398b", "xlstm-350m"
ARCHS = [JAMBA, XLSTM]
PARAM_SHAPES = {JAMBA: jamba_1_5_large_398b.param_shapes,
                XLSTM: xlstm_350m.param_shapes}
DTYPES = ["float32", "bfloat16"]
# (n_layers, d_ff) of the reduced models: one and two segments of the
# period of 2; xlstm also with d_ff = 0, the full model's "none"
SIZES = {JAMBA: [(2, 512), (4, 512)],
         XLSTM: [(2, 512), (4, 512), (2, 0)]}
CASES = [(arch, n, ff) for arch in ARCHS for n, ff in SIZES[arch]]


def near(got, want, dtype: str, rel: float = 1e-5) -> float:
    """max |got - want| within ``rel`` (f32) or BF16_STEPS (bf16) of the
    largest |want|; returns the gap over that bound."""
    got, want = as_np(got), as_np(want)
    scale = float(np.max(np.abs(want)))
    limit = (rel if dtype == "float32" else BF16_STEPS) * scale
    gap = float(np.max(np.abs(got - want)))
    assert scale > 0 and np.all(np.isfinite(got))
    assert gap <= limit, (gap, limit)
    return gap / limit


def _cfgs(arch: str, dtype: str = "float32", n_layers: int = 2,
          d_ff: int = 512, smoke: bool = True):
    """(reference, port) configs of ``arch``, reduced unless ``smoke`` is
    False, with the given depth, feed-forward width and dtype."""
    pair = (jax_get_config(arch, smoke=smoke), get_config(arch, smoke=smoke))
    if not smoke:
        return tuple(dataclasses.replace(c, dtype=dtype) for c in pair)
    return tuple(dataclasses.replace(c, dtype=dtype, n_layers=n_layers,
                                     d_ff=d_ff) for c in pair)


@functools.lru_cache(maxsize=None)
def _models(arch: str, dtype: str, n_layers: int = 2, d_ff: int = 512):
    """(JAX model, JAX params, port model, port params) of the reduced
    config, the port's params copied from the reference's."""
    jcfg, cfg = _cfgs(arch, dtype, n_layers, d_ff)
    jmodel = jax_build_model(jcfg, use_remat=False)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return jmodel, jparams, build_model(cfg), params


# -- configs, shapes and sharding rules ----------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch):
    """Every field at full size and reduced (xlstm: slstm_every 2, chunk
    32, d_ff 512; jamba: attn_every 2), the recurrent families'
    long-decode flag, and the period program."""
    for smoke in (False, True):
        got, want = get_config(arch, smoke=smoke), jax_get_config(
            arch, smoke=smoke)
        for f in dataclasses.fields(got):
            a, b = getattr(got, f.name), getattr(want, f.name)
            if dataclasses.is_dataclass(a):
                a, b = dataclasses.asdict(a), dataclasses.asdict(b)
            assert a == b, f.name
        assert got.hd == want.hd and got.supports_long_decode
        assert period_len(got) == (8 if not smoke else 2)
    full = get_config(arch)
    kinds = layer_kinds(full)[:8]
    if arch == JAMBA:
        assert kinds == [("mamba", "mlp"), ("mamba", "moe")] * 3 + [
            ("mamba", "mlp"), ("attn", "moe")]
        assert (full.mamba.d_state, full.mamba.d_conv, full.mamba.expand) == (
            16, 4, 2)
    else:
        assert kinds == [("mlstm", "none")] * 7 + [("slstm", "none")]
        small = get_config(arch, smoke=True)
        assert (small.xlstm.slstm_every, small.xlstm.chunk, small.d_ff) == (
            2, 32, 512)
        assert layer_kinds(small) == [("mlstm", "mlp"), ("slstm", "mlp")]


def test_every_reference_architecture_is_served():
    """``get_config`` serves all ten of the reference's architectures."""
    from repro.configs import ARCHS as JAX_ARCHS

    assert sorted(PORT_ARCHS) == sorted(JAX_ARCHS)
    for arch in JAX_ARCHS:
        assert get_config(arch).name == arch


@pytest.mark.parametrize("arch", ARCHS)
def test_param_shapes_match_reference_at_full_size(arch):
    """One stack per position of the 8-layer period: jamba's 9 segments
    (Mamba's f32 ``dt_bias``, ``a_log`` and ``d_skip``; MoE on the odd
    positions), xlstm's 3 (no ``norm2`` and ``ffn``); 397.5 B and
    241.6 M parameters."""
    leaves = check_param_shapes_at_full_size(arch, PARAM_SHAPES[arch])
    got = PARAM_SHAPES[arch]()
    n = sum(math.prod(s.shape) for s in tree_leaves(got))
    assert len(got["layers"]) == 8
    if arch == JAMBA:
        assert leaves == 3 + 4 * 14 + 3 * 15 + 10
        assert n == 397_499_179_008
        lay = got["layers"]
        assert lay[0]["mixer"]["a_log"] == ((9, 16384, 16), torch.float32)
        assert "router" in lay[1]["ffn"] and "router" not in lay[0]["ffn"]
        assert lay[7]["mixer"]["wq"] == ((9, 8192, 8192), torch.bfloat16)
    else:
        assert leaves == 3 + 7 * 7 + 5
        assert n == 241_644_544
        assert all("ffn" not in lay and "norm2" not in lay
                   for lay in got["layers"])
        assert got["layers"][7]["mixer"]["b"] == ((3, 4096), torch.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_input_shapes_match_reference(arch):
    """skip_reason is None for every shape, long_500k included; the batch
    stand-ins and the decode cache stand-ins at decode_32k and long_500k,
    path by path."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    model, jmodel = build_model(cfg), jax_build_model(jcfg)
    for name, shape in shapes.SHAPES.items():
        jshape = jax_shapes.SHAPES[name]
        assert shapes.skip_reason(cfg, shape) is None
        assert jax_shapes.skip_reason(jcfg, jshape) is None
        if shape.kind != "decode":
            got = shapes.token_batch_specs(cfg, shape)
            want = jax_shapes.token_batch_specs(jcfg, jshape)
            assert {k: tuple(v.shape) for k, v in got.items()} == {
                k: v.shape for k, v in want.items()}
            continue
        got = shapes.decode_input_specs(cfg, shape, model)
        want = jax_shapes.decode_input_specs(jcfg, jshape, jmodel)
        n = []

        def check(a, b):
            assert a.device.type == "meta"
            assert tuple(a.shape) == b.shape
            assert str(a.dtype).removeprefix("torch.") == str(b.dtype)
            n.append(1)

        tree_map(check, got["cache"], want["cache"])
        assert len(n) == len(jax.tree.leaves(want["cache"]))


class _StandIn:
    """What the reference's ``_spec`` and ``param_spec`` read of a mesh."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape)


MESHES = {"4x1": ((4, 1), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_cache_specs_match_reference(arch, mesh, monkeypatch):
    """``tree_param_specs`` on the full tree (``param_shapes`` as meta
    tensors) and ``cache_specs`` on a decode cache (batch 4, 64 steps:
    Mamba's conv and ssm, mLSTM's 5-D c, sLSTM's states, the attention
    layer's k and v) equal the reference's rules on the same shapes, by
    a stand-in mesh."""
    monkeypatch.setattr(jax_sharding, "NamedSharding",
                        lambda m, spec: tuple(spec))
    shape, names = MESHES[mesh]
    stand_in, ext = _StandIn(shape, names), dict(zip(names, shape))
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    meta = tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device="meta"), PARAM_SHAPES[arch]())
    jshapes = jax.eval_shape(jax_build_model(jcfg).init_params,
                             jax.random.PRNGKey(0))
    got = sharding.tree_param_specs(meta, ext)
    want = jax_sharding.tree_param_specs(jshapes, stand_in, jcfg)
    tree_map(_same_spec, got, want)
    cache = build_model(cfg).init_cache(4, 64, device="meta")
    jcache = jax.eval_shape(lambda: jax_build_model(jcfg).init_cache(4, 64))
    got = sharding.cache_specs(cache, ext)
    want = jax_sharding.cache_specs(jcache, stand_in, jcfg)
    tree_map(_same_spec, got, want)
    if arch == XLSTM and ext["model"] == 2:
        assert got["blocks"][0]["c"][2] == "model"        # mLSTM heads


def _same_spec(a, b):
    assert tuple(a) == tuple(b), (a, b)


# -- init ----------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_dtypes_and_laws(arch):
    """The drawn tree of the reduced bf16 model with two segments has
    ``param_shapes``' paths, shapes and dtypes and the reference's; the
    f32 leaves stay f32; the laws: a_log = log(1..S) on every channel,
    softplus(dt_bias) in [1e-3, 1e-1], D ones, conv std 1/d_conv, dense
    std scale / sqrt(d_in) (wout's scale 1 / sqrt(2 n_layers), sLSTM's
    recurrent 0.5) within 5 %, sLSTM's bias zeros."""
    jcfg, cfg = _cfgs(arch, "bfloat16", n_layers=4)
    want = jax.eval_shape(jax_build_model(jcfg).init_params,
                          jax.random.PRNGKey(0))
    params = build_model(cfg).init_params(torch.Generator().manual_seed(0))
    n = []

    def check(p, spec, ref):
        assert tuple(p.shape) == tuple(spec.shape) == tuple(ref.shape)
        assert p.dtype == spec.dtype
        assert str(p.dtype).removeprefix("torch.") == str(ref.dtype)
        n.append(1)

    tree_map(check, params, PARAM_SHAPES[arch](cfg), want)
    assert len(n) == len(jax.tree.leaves(want))
    d, nl = cfg.d_model, cfg.n_layers
    out_std = 1 / math.sqrt(2 * nl)
    if arch == JAMBA:
        m = params["layers"][0]["mixer"]
        di, s = 2 * d, cfg.mamba.d_state
        want_a = torch.log(torch.arange(1, s + 1, dtype=torch.float32))
        assert torch.equal(m["a_log"], want_a.expand(2, di, s))
        assert m["dt_bias"].dtype == m["d_skip"].dtype == torch.float32
        dt = torch.nn.functional.softplus(m["dt_bias"])
        assert float(dt.min()) >= 1e-3 * 0.999 and float(dt.max()) <= 0.1001
        assert torch.equal(m["d_skip"], torch.ones_like(m["d_skip"]))
        assert not m["conv_b"].any()
        assert m["wdt"].shape == (2, di, 1)
        laws = [(m["win"], 1 / math.sqrt(d)), (m["conv"], 1 / 4),
                (m["wbc"], 1 / math.sqrt(di)),
                (m["wout"], out_std / math.sqrt(di))]
    else:
        m, sl = params["layers"][0]["mixer"], params["layers"][1]["mixer"]
        assert sl["b"].dtype == torch.float32 and not sl["b"].any()
        laws = [(m["wq"], 1 / math.sqrt(d)), (m["wif"], 1 / math.sqrt(d)),
                (m["wout"], out_std / math.sqrt(d)),
                (sl["wx"], 1 / math.sqrt(d)), (sl["wr"], 0.5 / math.sqrt(d)),
                (sl["wout"], out_std / math.sqrt(d))]
    for w, std in laws:
        got = float(w.float().std())
        assert abs(got - std) <= 0.05 * std, (tuple(w.shape), got, std)
    # the segments are drawn one after another: no two share weights
    w = params["layers"][0]["mixer"]["wout"]
    assert not torch.equal(w[0], w[1])


# -- the Mamba layer -----------------------------------------------------------------


def _scan_inputs(b: int, t: int, di: int, s: int, seed: int):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((b, t, di)).astype(np.float32)
    dt = (0.1 * rng.random((b, t, di)) + 1e-3).astype(np.float32)
    bb = rng.standard_normal((b, t, s)).astype(np.float32)
    cc = rng.standard_normal((b, t, s)).astype(np.float32)
    a = -np.tile(np.arange(1, s + 1, dtype=np.float32)[None], (di, 1))
    return u, dt, bb, cc, a


@pytest.mark.parametrize("t,chunk", [(1, 256), (40, 256), (256, 256),
                                     (20, 8), (24, 8), (300, 256)])
def test_ssm_scan_matches_reference(t, chunk):
    """One scan at T <= chunk; chunks in order at T > chunk, with padding
    (T = 20 in chunks of 8: 4 pad steps) and without (24), and the
    carry; f32 within 1e-5 of the largest |y|."""
    args = _scan_inputs(2, t, 24, 16, seed=t)
    want = jax_mamba._ssm_scan(*map(jnp.asarray, args), chunk=chunk)
    got = mamba._ssm_scan(*map(torch.from_numpy, args), chunk=chunk)
    assert got.shape == (2, t, 24)
    near(got, want, "float32")


def test_scan_is_the_sequential_recurrence():
    """``_scan`` of (decay, inc) equals h_t = decay_t h_{t-1} + inc_t run
    step by step, for lengths that are and are not powers of two."""
    g = torch.Generator().manual_seed(4)
    for t in (1, 2, 7, 16, 33):
        decay = torch.rand((2, t, 5, 3), generator=g)
        inc = torch.randn((2, t, 5, 3), generator=g)
        h, want = torch.zeros((2, 5, 3)), []
        for i in range(t):
            h = decay[:, i] * h + inc[:, i]
            want.append(h)
        got = mamba._scan(decay, inc.clone())
        torch.testing.assert_close(got, torch.stack(want, 1), rtol=1e-5,
                                   atol=1e-6)


@functools.lru_cache(maxsize=None)
def _layer(arch: str, kind: str, dtype: str):
    """(reference params, port params, reference cfg, port cfg) of one
    reduced layer of ``kind`` from the reference's ``*_init(PRNGKey(3))``."""
    jcfg, cfg = _cfgs(arch, dtype)
    init = {"mamba": jax_mamba.mamba_init, "mlstm": jax_xlstm.mlstm_init,
            "slstm": jax_xlstm.slstm_init}[kind]
    jp = init(jax.random.PRNGKey(3), jcfg)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                 device="cpu"), jcfg, cfg


def _x(b: int, t: int, d: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((b, t, d)).astype(
        np.float32)


FORWARD = {"mamba": (jax_mamba.mamba_forward, mamba.mamba_forward),
           "mlstm": (jax_xlstm.mlstm_forward, xlstm.mlstm_forward),
           "slstm": (jax_xlstm.slstm_forward, xlstm.slstm_forward)}
DECODE = {"mamba": (jax_mamba.mamba_decode, jax_mamba.mamba_init_cache,
                    mamba.mamba_decode, mamba.mamba_init_cache),
          "mlstm": (jax_xlstm.mlstm_decode, jax_xlstm.mlstm_init_cache,
                    xlstm.mlstm_decode, xlstm.mlstm_init_cache),
          "slstm": (jax_xlstm.slstm_decode, jax_xlstm.slstm_init_cache,
                    xlstm.slstm_decode, xlstm.slstm_init_cache)}
KIND_ARCH = {"mamba": JAMBA, "mlstm": XLSTM, "slstm": XLSTM}


@pytest.mark.parametrize("t", [24, 70, 300])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm"])
def test_mixer_forward_matches_reference(kind, dtype, t):
    """One layer's prefill on the same inputs: Mamba at T within one
    scan (24, 70) and over two chunks (300); mLSTM within one chunk (24:
    chunk = T), padded (70: 3 chunks of 32, 26 pad steps) and over ten
    chunks (300, 20 pad steps); sLSTM step by step."""
    jp, p, jcfg, cfg = _layer(KIND_ARCH[kind], kind, dtype)
    x = _x(2, t, cfg.d_model, seed=t)
    jfwd, fwd = FORWARD[kind]
    want = jfwd(jp, jnp.asarray(x).astype(jcfg.jdtype), jcfg)
    got = fwd(p, torch.from_numpy(x).to(cfg.tdtype), cfg)
    assert got.shape == (2, t, cfg.d_model) and got.dtype == cfg.tdtype
    near(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm"])
def test_mixer_decode_matches_reference(kind, dtype):
    """20 decode steps from the empty cache against the reference's: the
    outputs and every state leaf (in place in the port's cache) each
    step."""
    jp, p, jcfg, cfg = _layer(KIND_ARCH[kind], kind, dtype)
    jdec, jinit, dec, init = DECODE[kind]
    x = _x(2, 20, cfg.d_model, seed=5)
    jcache, cache = jinit(jcfg, 2), init(cfg, 2, "cpu")
    held = {k: v for k, v in cache.items()}
    for i in range(20):
        want, jcache = jdec(jp, jnp.asarray(x[:, i:i + 1]).astype(jcfg.jdtype),
                            jcache, jcfg)
        got, out = dec(p, torch.from_numpy(x[:, i:i + 1]).to(cfg.tdtype),
                       cache, cfg)
        assert out is cache and all(cache[k] is held[k] for k in held)
        near(got, want, dtype)
        for name in cache:
            near(cache[name], jcache[name], dtype)


# -- the mLSTM chunkwise scan ----------------------------------------------------------


def _mlstm_inputs(b: int, h: int, t: int, hd: int, seed: int):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, t, hd)).astype(np.float32)
               for _ in range(3))
    logf = -np.log1p(np.exp(-rng.standard_normal((b, h, t)))).astype(
        np.float32)
    logi = rng.standard_normal((b, h, t)).astype(np.float32)
    return q, k, v, logf, logi


@pytest.mark.parametrize("t,chunk", [(24, 24), (96, 32), (64, 16)])
def test_mlstm_chunk_scan_matches_reference(t, chunk):
    """One chunk (T = chunk, as for T < the config's chunk) and several
    chunks carrying (C, n, m); f32 within 1e-5 of the largest |y|."""
    args = _mlstm_inputs(2, 3, t, 8, seed=t)
    want = jax_xlstm._mlstm_chunk_scan(*map(jnp.asarray, args), chunk)
    got = xlstm._mlstm_chunk_scan(*map(torch.from_numpy, args), chunk)
    assert got.shape == (2, 3, t, 8)
    near(got, want, "float32")


def test_mlstm_gates_are_interleaved_per_head():
    """``wif``'s 2H outputs are (i_0, f_0, i_1, f_1, ...): a weight whose
    even columns are 0 gives logi = 0 for every head."""
    _, p, _, cfg = _layer(XLSTM, "mlstm", "float32")
    w = p["wif"].clone()
    w[:, 0::2] = 0.0
    logi, logf = xlstm._gates({"wif": w}, torch.ones((1, 3, cfg.d_model)),
                              cfg.n_heads)
    assert logi.shape == (1, 3, cfg.n_heads) and not logi.any()
    assert torch.all(logf < 0)


# -- reduced models, whole -------------------------------------------------------------


@pytest.mark.parametrize("t", [40, 600])
@pytest.mark.parametrize("arch,n_layers,d_ff", CASES)
def test_forward_matches_reference(arch, n_layers, d_ff, t):
    """Logits through ``make_prefill`` in f32 within 1e-4 of the largest
    |logit|, and ``loss_fn`` to 1e-5 (jamba's aux term included). At
    T=600 the Mamba scan runs three chunks, the mLSTM 19 (the last
    padded), and jamba's attention layer takes the port's K9 op against
    the reference's ``_sdpa_chunked``; the MoE routes 19 groups of 64,
    the last padded."""
    jmodel, jparams, model, params = _models(arch, "float32", n_layers, d_ff)
    assert len(params["layers"]) == 2
    assert params["layers"][0]["norm1"]["w"].shape[0] == n_layers // 2
    toks = tokens(t + n_layers, 2, t, model.cfg.vocab)
    jb, pb = batches(toks, toks[:, ::-1].copy(), {})
    want, jaux = jmodel.forward(jparams, jb)
    got = make_prefill(model)(params, pb)
    assert got.shape == (2, t, model.cfg.vocab)
    near(got, want, "float32", rel=1e-4)
    with torch.no_grad():
        loss = model.loss_fn(params, pb)
    np.testing.assert_allclose(float(loss), float(jmodel.loss_fn(jparams, jb)),
                               rtol=1e-5)


@pytest.mark.parametrize("arch,n_layers,d_ff", CASES)
def test_each_layer_matches_reference_on_the_same_input(arch, n_layers,
                                                        d_ff):
    """Each layer of the whole model, segment by segment and position by
    position, fed the port's own input to it on both sides, within 1e-5
    of its largest |output| (f32, T=40)."""
    from repro.models import transformer as jax_transformer
    from repro_torch.models import transformer

    jmodel, jparams, model, params = _models(arch, "float32", n_layers, d_ff)
    toks = torch.from_numpy(tokens(1, 2, 40, model.cfg.vocab)).long()
    x = params["embed"][toks]
    for i in range(model.n_segments):
        for j, kind in enumerate(model.kinds):
            lp = tree_map(lambda a: a[i], params["layers"][j])
            jlp = jax.tree.map(lambda a: a[i], jparams["layers"][j])
            want, _ = jax_transformer._layer_forward(
                jlp, jnp.asarray(x.numpy()), jmodel.cfg, *kind)
            with torch.no_grad():
                x, _ = transformer._layer_forward(lp, x, model.cfg, *kind)
            near(x, want, "float32")


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_forward_matches_reference(arch):
    """In bf16 at T=40: xlstm whole within the bf16 tolerance of the
    reference's logits; jamba's Mamba-and-MLP layer (position 0) whole,
    the MoE layer being held in f32 (bf16 routes flip on near-ties)."""
    jmodel, jparams, model, params = _models(arch, "bfloat16")
    assert params["embed"].dtype == torch.bfloat16
    f32_leaves = [x for x in tree_leaves(params) if x.dtype == torch.float32]
    assert len(f32_leaves) == (4 if arch == JAMBA else 1)
    toks = tokens(3, 2, 40, model.cfg.vocab)
    if arch == XLSTM:
        jb, pb = batches(toks, toks, {})
        near(make_prefill(model)(params, pb), jmodel.forward(jparams, jb)[0],
             "bfloat16")
        return
    from repro.models import transformer as jax_transformer
    from repro_torch.models import transformer

    x = _x(2, 40, model.cfg.d_model, seed=3) * 0.1
    lp = tree_map(lambda a: a[0], params["layers"][0])
    jlp = jax.tree.map(lambda a: a[0], jparams["layers"][0])
    want, _ = jax_transformer._layer_forward(
        jlp, jnp.asarray(x).astype(jnp.bfloat16), jmodel.cfg, "mamba", "mlp")
    got, _ = transformer._layer_forward(lp, torch.from_numpy(x).to(
        torch.bfloat16), model.cfg, "mamba", "mlp")
    near(got, want, "bfloat16")


@pytest.mark.parametrize("arch,n_layers,d_ff", CASES)
def test_decode_matches_reference(arch, n_layers, d_ff):
    """20 tokens through the serve step against the reference's decode
    loop, f32 within 1e-4 of the largest |logit| at every step; the
    stacked caches are updated in place (a step returns the same cache
    tensors, and the recurrent states move)."""
    jmodel, jparams, model, params = _models(arch, "float32", n_layers, d_ff)
    toks = tokens(21 + n_layers, 2, 20, model.cfg.vocab)
    want = jax_decode(jmodel, jparams, toks, 24)
    serve = make_serve_step(model)
    cache = model.init_cache(2, 24, "cpu")
    held = tree_leaves(cache)
    first = [x.clone() for x in held]
    for pos in range(20):
        lg, cache = serve(params, cache, torch.from_numpy(
            toks[:, pos:pos + 1]).long(), pos)
        assert lg.shape == (2, 1, model.cfg.vocab)
        near(lg[:, 0], want[pos], "float32", rel=1e-4)
    assert all(a is b for a, b in zip(tree_leaves(cache), held))
    moved = [not torch.equal(a, b) for a, b in zip(held, first)]
    assert all(moved)


@pytest.mark.parametrize("arch,n_layers,d_ff", CASES)
def test_decode_matches_forward(arch, n_layers, d_ff):
    """Token-by-token decode equals the teacher-forced forward at every
    position to 1e-4 (f32) at T=300: the Mamba scan over two chunks,
    the mLSTM over ten. Jamba with capacity_factor = E / top_k, so no
    MoE grouping drops a token."""
    _, _, model, params = _models(arch, "float32", n_layers, d_ff)
    cfg = model.cfg
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
        model = build_model(cfg)
    toks = torch.from_numpy(tokens(7, 2, 300, cfg.vocab)).long()
    fwd = make_prefill(model)(params, {"tokens": toks})
    serve = make_serve_step(model)
    cache = model.init_cache(2, 300, "cpu")
    for pos in range(300):
        lg, cache = serve(params, cache, toks[:, pos:pos + 1], pos)
        torch.testing.assert_close(lg[:, 0], fwd[:, pos], atol=1e-4,
                                   rtol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_greedy_matches_reference_decode_loop(arch):
    """``generate(params=...)`` (its dtype from ``embed``, not the f32
    leaves): its greedy tokens are the reference's argmax along them."""
    jmodel, jparams, model, params = _models(arch, "float32")
    prompt_len, n_gen = 6, 8
    seqs = generate(arch, smoke=True, batch=2, prompt_len=prompt_len,
                    gen=n_gen, seed=7, greedy=True, device="cpu",
                    params=params)
    toks = seqs.numpy().astype(np.int32)
    logits = jax_decode(jmodel, jparams, toks[:, :-1], prompt_len + n_gen)
    for i in range(n_gen):
        np.testing.assert_array_equal(toks[:, prompt_len + i],
                                      logits[prompt_len - 1 + i].argmax(-1))


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_on_the_cpu(arch, monkeypatch, capsys):
    """``python -m repro_torch.launch.serve --arch ... --smoke --device
    cpu`` (the reference's docstring example): it prints the timing line
    and the first sequence's ids, those ``generate`` makes with the same
    arguments; no kernel launch on the CPU."""
    before = dict(LAUNCHES)
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", arch, "--smoke", "--batch", "2", "--prompt-len",
        "5", "--gen", "4", "--greedy", "--seed", "3", "--device", "cpu"])
    serve.main()
    out = capsys.readouterr().out
    assert "generated 4 tokens x 2 seqs" in out
    want = generate(arch, smoke=True, batch=2, prompt_len=5, gen=4, seed=3,
                    greedy=True, device="cpu")
    assert f"sample token ids: {want[0, :13].tolist()}" in out
    assert LAUNCHES == before

