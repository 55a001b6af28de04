"""The port's wire layer against the JAX reference's (``repro.wire``):
the bit streams and the traffic model bit for bit on numpy inputs made
from a seed; every registered family's payload structure and measured
bits (the port's ``meta`` structure against the reference's
``jax.eval_shape``); ``wire_cost``; and the codec byte for byte, each
package decoding the other's bytes, under every value format, sorted and
unsorted.

A family whose compress is exact arithmetic on the input (a selection,
a gather, one product or quotient: the Top-K family, Rand-K, natural
sparsification, identity) is compressed by both packages from the same
matrix (randomized ones on the reference's draws) and must give equal
bytes. A family that computes new floats (Rank-R's eigh, PowerSGD's
QRs, dithering's norm) agrees with the reference to rounding only, and
an eigenvector's sign is each package's own choice: its decoded matrices
are held to the reference's to 1e-12, and its port payload is then made
from the reference's arrays, so the bytes compared are the codec's alone.

Every JAX computation runs inside ``jax.enable_x64(True)``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)
from _torch_replay import compressor_draws
from repro.core import compressors as jc
from repro.wire import bitio as jbitio
from repro.wire import codec as jcodec
from repro.wire import report as jreport
from repro.wire import traffic as jtraffic
from repro_torch.core import compressors as tc
from repro_torch.wire import bitio, codec, report, traffic

# every registered family with a level, and two shapes: at (5, 5) the
# levels clamp (Top-K, Rand-K past numel, symmetric Top-K past the
# triangle, Rank-R past d)
LEVELS = {"rankr": 7, "rank": 2, "topk": 30, "topksym": 30, "powersgd": 2,
          "randk": 30, "dithering": 4, "randomdithering": 3, "natural": 0.3,
          "blocktopk": 20, "blocktopkthreshold": 20, "identity": None,
          "none": None, "zero": None}
SHAPES = [(5, 5), (12, 12)]


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _fields(payload) -> dict:
    """A payload's fields as numpy arrays and host values."""
    return {f.name: (_np(getattr(payload, f.name))
                     if hasattr(getattr(payload, f.name), "shape")
                     else getattr(payload, f.name))
            for f in dataclasses.fields(payload)}


def _same(a, b) -> bool:
    """Field for field, arrays bitwise (-0.0 != +0.0), same dtypes."""
    fa, fb = _fields(a), _fields(b)
    if type(a).__name__ != type(b).__name__ or list(fa) != list(fb):
        return False
    for name in fa:
        x, y = fa[name], fb[name]
        if isinstance(x, np.ndarray):
            if (x.dtype != y.dtype or x.shape != y.shape
                    or x.tobytes() != y.tobytes()):
                return False
        elif x != y:
            return False
    return True


# -- bitio and traffic ---------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bitio_matches_reference(seed):
    rng = np.random.default_rng(seed)
    widths = rng.integers(0, 40, 300)
    values = [int(rng.integers(0, 1 << int(w))) if w else 0 for w in widths]
    ws = [bitio.BitWriter(), jbitio.BitWriter()]
    for w in ws:
        for v, nb in zip(values, widths):
            w.write(v, int(nb))
        w.write_unary(37)
    assert ws[0].getvalue() == ws[1].getvalue() and len(ws[0]) == len(ws[1])
    buf = ws[0].getvalue()
    rd = bitio.BitReader(buf)
    assert [rd.read(int(nb)) for nb in widths] == values
    assert rd.read_unary() == 37

    signed = rng.integers(-(1 << 40), 1 << 40, 500)
    np.testing.assert_array_equal(bitio.zigzag(signed), jbitio.zigzag(signed))
    np.testing.assert_array_equal(bitio.unzigzag(bitio.zigzag(signed)), signed)
    sym = rng.geometric(0.01, 800).astype(np.uint64)
    r = bitio.best_rice_param(sym)
    assert r == jbitio.best_rice_param(sym)
    assert bitio.rice_stream_bits(sym, r) == jbitio.rice_stream_bits(sym, r)
    ws = [bitio.BitWriter(), jbitio.BitWriter()]
    bitio.write_rice_stream(ws[0], sym, r)
    jbitio.write_rice_stream(ws[1], sym, r)
    assert ws[0].getvalue() == ws[1].getvalue()
    assert len(ws[0]) == bitio.rice_stream_bits(sym, r)
    np.testing.assert_array_equal(
        bitio.read_rice_stream(bitio.BitReader(ws[0].getvalue()), sym.size, r),
        sym)


@pytest.mark.parametrize("preset", sorted(jtraffic.PRESETS))
def test_traffic_matches_reference_bitwise(preset):
    rng = np.random.default_rng(4)
    for n in (1, 7, 142):
        for seed in (0, 3):
            bits = float(rng.integers(1, 10 ** 7))
            assert np.array_equal(
                traffic.PRESETS[preset].silo_seconds(bits, n, seed=seed),
                jtraffic.PRESETS[preset].silo_seconds(bits, n, seed=seed))
            for reduce in ("max", "mean"):
                assert traffic.round_seconds(bits, preset, n, seed, reduce) \
                    == jtraffic.round_seconds(bits, preset, n, seed, reduce)
            assert np.array_equal(
                traffic.seconds_curve(bits, preset, n, 9, init_bits=bits / 3,
                                      seed=seed),
                jtraffic.seconds_curve(bits, preset, n, 9,
                                       init_bits=bits / 3, seed=seed))
            assert traffic.transfer_seconds(int(bits) // 8, preset, n, seed) \
                == jtraffic.transfer_seconds(int(bits) // 8, preset, n, seed)


def test_traffic_custom_link_and_errors():
    link = traffic.LinkModel("x", 5e6, 0.01, bandwidth_sigma=0.3)
    ref = jtraffic.LinkModel("x", 5e6, 0.01, bandwidth_sigma=0.3)
    assert traffic.round_seconds(1e5, link, 30) == \
        jtraffic.round_seconds(1e5, ref, 30)
    assert traffic.link_model(None) is None
    with pytest.raises(ValueError, match="unknown link preset"):
        traffic.link_model("carrier-pigeon")
    with pytest.raises(ValueError, match="reduce"):
        traffic.round_seconds(1.0, "wan", 2, reduce="median")


# -- payload structure and bits -------------------------------------------------


def _reference_structure(family, level, shape, dtype):
    with jax.enable_x64(True):
        comp = jc.make_compressor(family, level)
        m = jax.ShapeDtypeStruct(shape, jnp.dtype(dtype))
        key = jax.ShapeDtypeStruct((2,), jnp.dtype(jnp.uint32))
        return jax.eval_shape(comp.compress, m, key)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("family", sorted(LEVELS))
def test_payload_structure_and_bits_match_reference(family, shape):
    """The port's meta structure (one silo on a leading axis) has the
    reference's ``eval_shape`` structure, and every accounting equals
    the reference's, clamps included, in f64 and f32."""
    for tdtype, jdtype in ((torch.float64, np.float64),
                           (torch.float32, np.float32)):
        comp = tc.make_compressor(family, LEVELS[family])
        ours = comp.structure(shape, tdtype)
        ref = _reference_structure(family, LEVELS[family], shape, jdtype)
        assert type(ours).__name__ == type(ref).__name__
        for f in dataclasses.fields(ours):
            a, b = getattr(ours, f.name), getattr(ref, f.name)
            if isinstance(a, torch.Tensor):
                assert a.device.type == "meta"
                assert tuple(a.shape) == (1,) + tuple(b.shape), f.name
                assert str(a.dtype).replace("torch.", "") == str(b.dtype)
            else:
                assert a == b, f.name
        with jax.enable_x64(True):
            jcomp = jc.make_compressor(family, LEVELS[family])
            for coding in ("raw", "entropy"):
                assert tc.payload_bits(comp, shape, tdtype, coding) == \
                    jc.payload_bits(jcomp, shape, jdtype, coding)
            assert comp.bits(shape) == jcomp.bits(shape)
    assert tc.payload_bits(comp, shape, index_coding="entropy") <= \
        tc.payload_bits(comp, shape)


@pytest.mark.parametrize("make,shape", [
    (lambda m: m.TopK(k=100), (3, 3)), (lambda m: m.TopK(k=9), (3, 3)),
    (lambda m: m.TopK(k=100, symmetric=True), (4, 4)),
    (lambda m: m.TopK(k=3, symmetric=True), (4, 4)),
    (lambda m: m.RandK(k=100), (3, 3)),
    (lambda m: m.BlockTopK(k_per_block=100, block=4), (4, 4)),
    (lambda m: m.RankR(r=100), (5, 5)), (lambda m: m.Zero(), (5, 5))],
    ids=["topk", "topk-exact", "topk-sym", "topk-sym-3", "randk",
         "blocktopk", "rankr", "zero"])
def test_bits_clamped_and_equal_to_payload_structure(make, shape):
    """test_payloads.py's clamps: the analytic claim is what the payload
    can contain, and equals the measured structure (f64), as in the
    reference."""
    comp = make(tc)
    assert comp.bits(shape) == tc.payload_bits(comp, shape)
    with jax.enable_x64(True):
        assert comp.bits(shape) == make(jc).bits(shape) == \
            jc.payload_bits(make(jc), shape)


def test_structure_allocates_nothing_at_the_embed_shape():
    """``uplink_bits`` asks for the structure at qwen2's embed shape: meta
    tensors, so no memory at the tensor's size."""
    comp = tc.BlockTopKThreshold(k_per_block=2048)
    pay = comp.structure((151936, 896))
    assert pay.values.device.type == "meta"
    assert pay.values.shape == (1, 1187 * 7, 2048)
    with jax.enable_x64(True):
        assert tc.payload_bits(comp, (151936, 896)) == jc.payload_bits(
            jc.BlockTopKThreshold(k_per_block=2048), (151936, 896))


def test_payload_bits_rejects_unknown_coding():
    pay = tc.TopK(3).structure((4, 4))
    with pytest.raises(ValueError, match="index_coding"):
        pay.bits("huffman")
    assert tc.canonical_float_bits() == 64
    assert tc.canonical_float_bits(torch.float32) == 32


# -- wire_cost -------------------------------------------------------------------


DETERMINISTIC = ["topk", "topksym", "rankr", "powersgd", "blocktopk",
                 "blocktopkthreshold", "identity", "zero"]


@pytest.mark.parametrize("family", sorted(LEVELS))
def test_wire_cost_matches_reference(family):
    """Analytic, raw and entropy bits equal for every family; the encoded
    size equal on a shared sample for the deterministic ones (a
    randomized one draws from a generator of its package's own)."""
    shape = (12, 12)
    sample = np.random.default_rng(7).standard_normal(shape)
    comp = tc.make_compressor(family, LEVELS[family])
    with jax.enable_x64(True):
        jcomp = jc.make_compressor(family, LEVELS[family])
        ref = jreport.wire_cost(jcomp, shape, sample=jnp.asarray(sample))
        ref_f32 = jreport.wire_cost(jcomp, shape, dtype=jnp.float32,
                                    encoded=False)
    ours = report.wire_cost(comp, shape, sample=sample)
    assert (ours.analytic_bits, ours.raw_bits, ours.entropy_bits) == \
        (ref.analytic_bits, ref.raw_bits, ref.entropy_bits)
    ours_f32 = report.wire_cost(comp, shape, dtype=torch.float32,
                                encoded=False)
    assert dataclasses.astuple(ours_f32) == dataclasses.astuple(ref_f32)
    if family in DETERMINISTIC:
        assert ours.encoded_bytes == ref.encoded_bytes > 0
    default = report.wire_cost(comp, shape)          # the port's own sample
    assert default.encoded_bytes > 0 or family == "zero"
    assert default.seconds("wan", n=4) == jtraffic.round_seconds(
        8.0 * default.encoded_bytes, "wan", n=4)


# -- the codec: cross-decode -------------------------------------------------------


D = 16
EXACT = {
    "topk": lambda m: m.TopK(k=3 * D),
    "topk-sym": lambda m: m.TopK(k=2 * D, symmetric=True),
    "randk": lambda m: m.RandK(k=3 * D),
    "blocktopk": lambda m: m.BlockTopK(k_per_block=5, block=8),
    "blocktopk-threshold": lambda m: m.BlockTopKThreshold(k_per_block=5,
                                                          block=8),
    "natural": lambda m: m.NaturalSparsification(p=0.3),
    "identity": lambda m: m.Identity(),
}
FLOATS = {
    "rankr": lambda m: m.RankR(2),
    "powersgd": lambda m: m.PowerSGD(r=2),
    "dithering": lambda m: m.RandomDithering(s=4),
}


def _matrix(dtype, seed=0, silos=1):
    """(silos, D, D) symmetric matrices with a -0.0 entry pair."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((silos, D, D))
    x[:, 3, 4] = x[:, 4, 3] = -0.0
    return (0.5 * (x + x.transpose(0, 2, 1))).astype(dtype)


def _payloads(name, x):
    """(port stacked payload, reference vmapped payload) of ``name`` on
    the (silos, D, D) numpy ``x``, the randomized ones on the reference's
    draws."""
    family = {**EXACT, **FLOATS}[name]
    comp, jcomp = family(tc), family(jc)
    with jax.enable_x64(True):
        keys = jax.random.split(jax.random.PRNGKey(3), x.shape[0])
        ref = jax.vmap(jcomp.compress)(jnp.asarray(x), keys)
    draw = compressor_draws(comp, keys, (D, D))
    ours = comp.apply(torch.from_numpy(x), draw)
    if name in FLOATS:
        # the decoded matrices agree (an eigenvector's sign is each
        # package's own choice, so the factors may not)
        with jax.enable_x64(True):
            dense = jax.vmap(lambda p: jcomp.decompress(p, (D, D)))(ref)
        np.testing.assert_allclose(_np(comp.decompress(ours, (D, D))),
                                   np.asarray(dense), rtol=0, atol=1e-12)
        ours = dataclasses.replace(ours, **{
            f.name: torch.from_numpy(np.array(getattr(ref, f.name)))
            for f in dataclasses.fields(ours)
            if isinstance(getattr(ours, f.name), torch.Tensor)})
    return comp, ours, ref


@pytest.mark.parametrize("sort", [True, False], ids=["sorted", "unsorted"])
@pytest.mark.parametrize("fmt", ["raw", "fp16", "int8"])
@pytest.mark.parametrize("name", sorted({**EXACT, **FLOATS}))
def test_codec_bytes_equal_and_cross_decode(name, fmt, sort):
    x = _matrix(np.float64, silos=3)
    comp, ours, ref = _payloads(name, x)
    with jax.enable_x64(True):
        want = list(jcodec.encode_silos(ref, value_format=fmt,
                                        sort_indices=sort))
        ref_decoded = [jcodec.decode(b) for b in want]
        ref_canonical = [jcodec.canonical(jax.tree_util.tree_map(
            lambda a: a[i], ref)) for i in range(x.shape[0])]
    got = list(codec.encode_silos(ours, value_format=fmt, sort_indices=sort))
    assert got == want
    for i, buf in enumerate(got):
        mine = codec.decode(buf)
        assert _same(mine, ref_decoded[i])                # the same payload
        if fmt == "raw" and sort:
            assert _same(mine, ref_canonical[i])          # == canonical(p)
            assert _same(codec.canonical(dataclasses.replace(ours, **{
                k: v[i] for k, v in _fields(ours).items()
                if isinstance(v, np.ndarray)})), ref_canonical[i])
        if fmt != "int8":       # int8's scale is not a fixed point
            assert codec.encode(mine, value_format=fmt,
                                sort_indices=sort) == buf
    # decode, stack, decompress: the original's decompress under raw
    back = comp.decompress(codec.decode_silos(got), (D, D))
    if fmt == "raw":
        assert torch.equal(back, comp.decompress(ours, (D, D)))


# -- padding, signed zero, malformed buffers -------------------------------------


def test_minus_one_padding_survives():
    p = tc.SparsePayload(values=torch.tensor([[1.5, -2.0, 0.0, 0.0]]),
                         indices=torch.tensor([[7, 3, -1, -1]],
                                              dtype=torch.int32),
                         universe=D * D)
    (buf,) = codec.encode_silos(p)
    with jax.enable_x64(True):
        ref = jc.SparsePayload(values=jnp.array([1.5, -2.0, 0.0, 0.0],
                                                jnp.float32),
                               indices=jnp.array([7, 3, -1, -1], jnp.int32),
                               universe=D * D)
        assert jcodec.encode(ref) == buf
    dec = codec.decode(buf)
    assert np.sum(dec.indices == -1) == 2
    assert _same(dec, codec.canonical(dataclasses.replace(
        p, values=p.values[0], indices=p.indices[0])))
    comp = tc.TopK(k=4)
    assert torch.equal(comp.decompress(codec.decode_silos([buf]), (D, D)),
                       comp.decompress(p, (D, D)))


def test_negative_zero_survives_indexed_dense():
    p = tc.DensePayload(values=torch.tensor([[0.0, -0.0], [3.0, 0.0]]),
                        count=1, indexed=True, universe=4)
    buf = codec.encode(p)
    with jax.enable_x64(True):
        assert jcodec.encode(jc.DensePayload(
            values=jnp.array([[0.0, -0.0], [3.0, 0.0]], jnp.float32),
            count=1, indexed=True, universe=4)) == buf
    got = codec.decode(buf).values
    assert got[0, 1] == 0.0 and np.signbit(got[0, 1])
    assert not np.signbit(got[0, 0])
    assert _same(codec.decode(buf), codec.canonical(p))


def test_decode_rejects_garbage_and_wrong_shape():
    with pytest.raises(codec.WireFormatError):
        codec.decode(b"\x00\x01\x02\x03")
    with pytest.raises(codec.WireFormatError, match="version"):
        codec.decode(b"\xfe\x07\x01\x00")
    with pytest.raises(codec.WireFormatError, match="family"):
        codec.decode(b"\xfe\x01\x09\x00")
    comp = tc.Identity()
    (buf,) = codec.encode_silos(comp.compress(torch.ones(1, D, D)))
    with pytest.raises(codec.WireFormatError):
        codec.decode(buf, shape=(D + 1, D + 1))
    with pytest.raises(codec.WireFormatError):
        codec.encode(codec.decode(buf), value_format="fp8")
    with pytest.raises(codec.WireFormatError, match="no codec"):
        codec.encode(object())


def test_stacked_payload_must_use_encode_silos():
    stack = tc.TopK(k=3 * D).compress(torch.randn(4, D, D))
    with pytest.raises(codec.WireFormatError, match="encode_silos"):
        codec.encode(stack)
    bufs = codec.encode_silos(stack)
    assert not isinstance(bufs, list)                  # a lazy generator
    sizes = report.silo_encoded_bytes(stack)
    assert sizes.shape == (4,) and np.all(sizes == [len(b) for b in
                                                    codec.encode_silos(stack)])
