"""The port's encoder-decoder (whisper-tiny) and VLM (llava-next-34b)
against the JAX package, on the CPU: the configs, ``param_shapes`` at
full size, the input shapes (``patches`` and ``frames``),
``init_params``' tree and laws, ``sinusoid`` and ``sinusoid_at``, the
encoder, its non-causal self-attention, ``cross_forward``, and reduced
whisper and llava whole in f32 and bf16 (forward on both attention
branches, the loss, llava's on the text positions only), the loss's
gradient at T=600, decode (whisper's with the encoder's memory in the
cache) and greedy ``generate``; ``add_modality_inputs``' shapes. Inputs
come from numpy seeds, weights from the reference's
``init_params(PRNGKey(0))``. Tolerances as ``_torch_lm.close``: f32 to
1e-4, bf16 within 4 bf16 steps of the largest |value|.

``sinusoid``: both sides take pos / 10000^(2i/d) in f32, and one ulp of
``pow`` moves an angle by about pos * 6e-8, so the tables agree within
1.2e-7 * max(pos, 1) (checked up to T = 1,030).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_lm import (  # noqa: F401 (fixture)
    DTYPES,
    batches,
    check_grads_against_reference,
    check_param_shapes_at_full_size,
    close,
    jax_decode,
    modality_inputs,
    models,
    no_activation_sharder,
    tokens,
)
from _torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

from repro.configs import get_config as jax_get_config
from repro.launch import shapes as jax_shapes
from repro.models import attention as jax_attention
from repro.models import transformer as jax_transformer
from repro_torch.configs import get_config, llava_next_34b, whisper_tiny
from repro_torch.kernels import LAUNCHES
from repro_torch.launch import shapes
from repro_torch.launch.serve import generate
from repro_torch.launch.steps import make_prefill, make_serve_step
from repro_torch.launch.train import add_modality_inputs
from repro_torch.models import attention, build_model, transformer
from repro_torch.tree import tree_leaves, tree_map

pytestmark = pytest.mark.usefixtures("no_activation_sharder")

WHISPER, LLAVA = "whisper-tiny", "llava-next-34b"
ARCHS = [WHISPER, LLAVA]
PARAM_SHAPES = {WHISPER: whisper_tiny.param_shapes,
                LLAVA: llava_next_34b.param_shapes}
# leaves of the tree: whisper's decoder layer adds norm_x and cross to a
# layernorm, gelu block; its encoder's layers and final norm follow
LEAVES = {WHISPER: 32, LLAVA: 12}


# -- configs and shapes --------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch):
    for smoke in (False, True):
        got, want = get_config(arch, smoke=smoke), jax_get_config(
            arch, smoke=smoke)
        for f in dataclasses.fields(got):
            assert getattr(got, f.name) == getattr(want, f.name), f.name
        assert got.hd == want.hd
    small = get_config(arch, smoke=True)
    if arch == WHISPER:
        assert (small.enc_layers, small.enc_seq, small.rope) == (2, 32, False)
        assert small.n_heads == small.kv_heads
    else:
        assert small.vision_tokens == 16
        assert get_config(arch).vision_tokens == 2880


@pytest.mark.parametrize("arch", ARCHS)
def test_param_shapes_match_reference_at_full_size(arch):
    assert check_param_shapes_at_full_size(arch, PARAM_SHAPES[arch]) == \
        LEAVES[arch]
    got = PARAM_SHAPES[arch]()
    assert ("enc_layers" in got) == ("cross" in got["layers"][0]) == (
        arch == WHISPER)


@pytest.mark.parametrize("arch", ARCHS)
def test_input_shapes_match_reference(arch):
    """skip_reason, the batch stand-ins (llava: ``patches`` and text
    T - 2,880; whisper: ``frames`` (B, 1,500, 384)) and the decode
    stand-ins with whisper's ``enc``, for every assigned shape."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    model, jmodel = build_model(cfg), jax_transformer.build_model(jcfg)
    for name, shape in shapes.SHAPES.items():
        jshape = jax_shapes.SHAPES[name]
        assert shapes.skip_reason(cfg, shape) == jax_shapes.skip_reason(
            jcfg, jshape)
        if shape.kind != "decode":
            got = shapes.token_batch_specs(cfg, shape)
            want = jax_shapes.token_batch_specs(jcfg, jshape)
            assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
                    for k, v in got.items()} == {
                k: (v.shape, str(v.dtype)) for k, v in want.items()}
            assert all(v.device.type == "meta" for v in got.values())
        elif name == "decode_32k":
            got = shapes.decode_input_specs(cfg, shape, model)
            want = jax_shapes.decode_input_specs(jcfg, jshape, jmodel)
            assert set(got["cache"]) == set(want["cache"])
            assert ([tuple(x.shape) for x in tree_leaves(got["cache"])]
                    == [x.shape for x in jax.tree.leaves(want["cache"])])


def _init_cfgs(arch: str):
    """(port, reference) bf16 configs: whisper-tiny whole at full size,
    llava reduced (34 B parameters do not fit a CPU test)."""
    pair = ((get_config(arch), jax_get_config(arch)) if arch == WHISPER
            else (get_config(arch, smoke=True),
                  jax_get_config(arch, smoke=True)))
    return tuple(dataclasses.replace(c, dtype="bfloat16") for c in pair)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_and_laws(arch):
    """The drawn tree has ``param_shapes``' and the reference's paths,
    shapes and dtypes; layernorm weights ones and biases zeros; the
    embeddings N(0, 0.02), dense weights scale / sqrt(d_in) within 5 %."""
    cfg, jcfg = _init_cfgs(arch)
    want = jax.eval_shape(jax_transformer.build_model(jcfg).init_params,
                          jax.random.PRNGKey(0))
    params = build_model(cfg).init_params(torch.Generator().manual_seed(0))
    n = []

    def check(p, spec, ref):
        assert tuple(p.shape) == tuple(spec.shape) == tuple(ref.shape)
        assert p.dtype == spec.dtype == torch.bfloat16
        n.append(1)

    tree_map(check, params, PARAM_SHAPES[arch](cfg), want)
    assert len(n) == len(jax.tree.leaves(want)) == LEAVES[arch]
    layer, d = params["layers"][0], cfg.d_model
    norms = [params["norm_f"], layer["norm1"], layer["norm2"]]
    if arch == WHISPER:
        norms += [layer["norm_x"], params["enc_norm_f"],
                  params["enc_layers"]["norm1"]]
    for nm in norms:
        assert torch.equal(nm["w"], torch.ones_like(nm["w"]))
        assert "b" not in nm or not nm["b"].any()
    laws = [(params["embed"], 0.02), (layer["mixer"]["wq"], 1 / math.sqrt(d)),
            (layer["ffn"]["wi"], 1 / math.sqrt(d))]
    if arch == WHISPER:
        laws += [(layer["cross"]["wk"], 1 / math.sqrt(d)),
                 (params["enc_layers"]["ffn"]["wo"],
                  1 / math.sqrt(2 * cfg.n_layers) / math.sqrt(cfg.d_ff))]
    for w, std in laws:
        got = float(w.float().std())
        assert abs(got - std) <= 0.05 * std, (tuple(w.shape), got, std)


def test_add_modality_inputs():
    """llava: ``patches`` (B, 16, d); whisper: ``frames`` (B, 32, d); in
    the model's dtype, N(0, 1) * 0.02, the same for the same step and
    other for another; a dense batch passes through unchanged."""
    toks = torch.zeros((3, 8), dtype=torch.int32)
    for arch, key, n in ((LLAVA, "patches", 16), (WHISPER, "frames", 32)):
        for dtype in ("float32", "bfloat16"):
            cfg = dataclasses.replace(get_config(arch, smoke=True),
                                      dtype=dtype)
            b = add_modality_inputs({"tokens": toks}, cfg, 5)
            x = b[key]
            assert x.shape == (3, n, cfg.d_model) and x.dtype == cfg.tdtype
            assert 0.015 < float(x.float().std()) < 0.025
            assert torch.equal(add_modality_inputs({"tokens": toks}, cfg,
                                                   5)[key], x)
            assert not torch.equal(add_modality_inputs({"tokens": toks}, cfg,
                                                       6)[key], x)
    dense = {"tokens": toks}
    assert add_modality_inputs(dense, get_config("qwen2-0.5b"), 0) is dense


# -- sinusoidal positions, the encoder and cross-attention -------------------------


@pytest.mark.parametrize("d", [256, 384])
def test_sinusoid_matches_reference(d):
    """The table and its rows (``sinusoid_at``) within 1.2e-7 * max(pos,
    1) of the reference's, f32, up to T = 1,030; row 0 exact; the rows
    equal the port's own table bit for bit."""
    want = np.asarray(jax_transformer.sinusoid(1030, d, jnp.float32))
    got = transformer.sinusoid(1030, d, torch.float32).numpy()
    pos = np.maximum(np.arange(1030), 1)[:, None]
    assert np.all(np.abs(got - want) <= 1.2e-7 * pos)
    assert np.array_equal(got[0], want[0])
    for p in (0, 1, 17, 511, 600, 1029):
        row = transformer.sinusoid_at(p, d, torch.float32).numpy()
        ref = np.asarray(jax_transformer.sinusoid_at(jnp.int32(p), d,
                                                     jnp.float32))
        assert np.all(np.abs(row - ref) <= 1.2e-7 * max(p, 1))
        assert np.array_equal(row, got[p])
    assert transformer.sinusoid(5, d, torch.bfloat16).dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", DTYPES)
def test_encoder_matches_reference(dtype):
    """The encoder stack (non-causal self-attention, no RoPE) with its
    final norm over 32 frames, and one encoder layer alone."""
    jmodel, jparams, model, params = models(WHISPER, dtype)
    frames = modality_inputs(model.cfg, 2, 1)["frames"]
    want = jmodel._encode(jparams, jnp.asarray(frames))
    with torch.no_grad():
        got = model._encode(params, torch.from_numpy(frames))
    assert got.shape == (2, 32, model.cfg.d_model)
    close(got, want, dtype)
    cfg, jcfg = model.cfg, jmodel.cfg
    x = np.random.default_rng(2).standard_normal((2, 32, cfg.d_model)).astype(
        np.float32)
    lp = tree_map(lambda a: a[0], params["enc_layers"])
    jlp = jax.tree.map(lambda a: a[0], jparams["enc_layers"])
    want, _ = jax_transformer._layer_forward(
        jlp, jnp.asarray(x).astype(jcfg.jdtype), jcfg, "attn", "mlp",
        causal=False)
    with torch.no_grad():
        got, aux = transformer._layer_forward(
            lp, torch.from_numpy(x).to(cfg.tdtype), cfg, "attn", "mlp",
            causal=False)
    close(got, want, dtype)
    assert float(aux) == 0.0


@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_forward_matches_reference(dtype):
    """Decoder queries (T = 40) over a memory of S = 32 frames, every key
    attended; and a future memory row changes every query's output."""
    jmodel, jparams, model, params = models(WHISPER, dtype)
    cfg, jcfg = model.cfg, jmodel.cfg
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[0], jparams["layers"][0]["cross"])
    p = tree_map(lambda a: a[0], params["layers"][0]["cross"])
    want = jax_attention.cross_forward(jp, jnp.asarray(x).astype(jcfg.jdtype),
                                       jnp.asarray(mem).astype(jcfg.jdtype),
                                       jcfg)
    tx, tm = (torch.from_numpy(a).to(cfg.tdtype) for a in (x, mem))
    got = attention.cross_forward(p, tx, tm, cfg)
    close(got, want, dtype)
    tm2 = tm.clone()
    tm2[:, -1] += 1.0
    moved = (attention.cross_forward(p, tx, tm2, cfg) - got).abs().amax(-1)
    assert bool((moved > 0).all())


# -- reduced whisper and llava, whole -------------------------------------------------


@pytest.mark.parametrize("t", [64, 600])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_reference(arch, dtype, t):
    """T = 64 runs ``_sdpa`` on both sides; T = 600 (llava: 16 patches and
    584 tokens) the port's K9 op against the reference's
    ``_sdpa_chunked``. Logits by ``close``; the loss (llava's on the
    text positions) to 1e-4 in f32 and 1e-2 in bf16."""
    jmodel, jparams, model, params = models(arch, dtype)
    cfg = model.cfg
    t_text = t - cfg.vision_tokens
    toks = tokens(t, 2, t_text, cfg.vocab)
    jb, pb = batches(toks, toks[:, ::-1].copy(), modality_inputs(cfg, 2, t))
    want, _ = jmodel.forward(jparams, jb)
    with torch.no_grad():
        got, aux = model.forward(params, pb)
        loss = model.loss_fn(params, pb)
    assert got.shape == (2, t, cfg.vocab) and float(aux) == 0.0
    close(got, want, dtype)
    np.testing.assert_allclose(float(loss), float(jmodel.loss_fn(jparams, jb)),
                               rtol=1e-4 if dtype == "float32" else 1e-2)


def test_vlm_loss_is_on_text_positions_only():
    """Targets under the patches do not exist: the loss is the
    cross-entropy of the text positions' logits alone."""
    _, _, model, params = models(LLAVA, "float32")
    cfg = model.cfg
    toks = tokens(9, 2, 20, cfg.vocab)
    _, pb = batches(toks, toks[:, ::-1].copy(), modality_inputs(cfg, 2, 9))
    with torch.no_grad():
        logits, _ = model.forward(params, pb)
        loss = model.loss_fn(params, pb)
    text = logits[:, cfg.vision_tokens:]
    want = torch.nn.functional.cross_entropy(
        text.reshape(-1, cfg.vocab), pb["targets"].reshape(-1))
    torch.testing.assert_close(loss, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_grad_matches_reference_above_512_tokens(arch):
    """At T = 600 (decoder) both sides differentiate their
    ``_sdpa_chunked``; whisper's encoder and cross-attention and llava's
    text-only loss are in the graph. No K9 launch; every leaf within
    1e-4 of its largest |grad|."""
    jmodel, jparams, model, params = models(arch, "float32")
    cfg = model.cfg
    toks = tokens(17, 2, 600 - cfg.vision_tokens, cfg.vocab)
    before = dict(LAUNCHES)
    n = check_grads_against_reference(jmodel, jparams, model, params, toks,
                                      modality_inputs(cfg, 2, 17))
    assert n == len(tree_leaves(params)) and LAUNCHES == before


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference(arch, dtype):
    """16 tokens through the serve step; whisper's cache holds the
    encoder's output as ``enc`` (the same array on both sides), and each
    step adds ``sinusoid_at(pos)``; llava decodes text alone."""
    jmodel, jparams, model, params = models(arch, dtype)
    toks = tokens(23, 2, 16, model.cfg.vocab)
    enc = None
    serve = make_serve_step(model)
    cache = model.init_cache(2, 20, "cpu")
    if arch == WHISPER:
        assert cache["enc"].shape == (2, 32, model.cfg.d_model)
        enc = np.random.default_rng(4).standard_normal(
            cache["enc"].shape).astype(np.float32)
        cache["enc"] = torch.from_numpy(enc).to(model.cfg.tdtype)
    want = jax_decode(jmodel, jparams, toks, 20, enc=enc)
    for pos in range(16):
        lg, cache = serve(params, cache, torch.from_numpy(
            toks[:, pos:pos + 1]).long(), pos)
        close(lg[:, 0], want[pos], dtype)


def test_whisper_decode_matches_forward_with_the_encoders_memory():
    """Teacher-forced forward logits (T = 600, the K9 branch at n_rep 1)
    equal token-by-token decode logits with ``cache["enc"]`` set to the
    encoder's output on the same frames, to 2e-3."""
    _, _, model, params = models(WHISPER, "float32")
    toks = torch.from_numpy(tokens(5, 1, 600, model.cfg.vocab)).long()
    frames = torch.from_numpy(modality_inputs(model.cfg, 1, 5)["frames"])
    fwd = make_prefill(model)(params, {"tokens": toks, "frames": frames})
    serve = make_serve_step(model)
    cache = model.init_cache(1, 600, "cpu")
    with torch.no_grad():
        cache["enc"] = model._encode(params, frames)
    for pos in range(600):
        lg, cache = serve(params, cache, toks[:, pos:pos + 1], pos)
        torch.testing.assert_close(lg[:, 0], fwd[:, pos], atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_greedy_matches_reference_decode_loop(arch):
    """Greedy tokens are the reference's argmax along them; whisper's
    memory (N(0, 1) * 0.02 from a numpy seed) goes to ``generate`` and to
    the reference's cache alike. Without it, ``generate`` draws its own."""
    jmodel, jparams, model, params = models(arch, "float32")
    prompt_len, n_gen, seed = 6, 8, 11
    enc = memory = None
    if arch == WHISPER:
        enc = (np.random.default_rng(seed).standard_normal(
            (2, model.cfg.enc_seq, model.cfg.d_model)) * 0.02).astype(
                np.float32)
        memory = torch.from_numpy(enc)
        drawn = generate(arch, smoke=True, batch=2, prompt_len=prompt_len,
                         gen=2, seed=seed, greedy=True, device="cpu",
                         params=params)
        assert drawn.shape == (2, prompt_len + 2)
    seqs = generate(arch, smoke=True, batch=2, prompt_len=prompt_len,
                    gen=n_gen, seed=seed, greedy=True, device="cpu",
                    params=params, memory=memory)
    toks = seqs.numpy().astype(np.int32)
    logits = jax_decode(jmodel, jparams, toks[:, :-1], prompt_len + n_gen,
                        enc=enc)
    for i in range(n_gen):
        np.testing.assert_array_equal(toks[:, prompt_len + i],
                                      logits[prompt_len - 1 + i].argmax(-1))
