"""The port's roofline (``launch/roofline.py``) and dry run
(``launch/dryrun.py``) against the JAX package, on the CPU.

``count_params`` (whole and active-only) and ``model_flops`` equal the
reference's for all ten architectures, published and reduced, at every
shape of ``SHAPES``; the analytic count is within 2 % of the meta tree's
size (the reference's criterion, ``tests/test_models_smoke.py:145``).
The dry run's counting mode is held to hand counts (one GEMM, one causal
attention call through K9's stand-in and one through the plain masked
path), its probes to the full count, ``collective_bytes`` to a hand
count on a {data 2, model 4} mesh, and ``dryrun_pair`` gives a row with
the reference's keys (``ok``) or the reference's ``skip`` for every
reduced (arch, shape) pair on the meta device.

Only the reference's ``launch.roofline``, ``launch.shapes`` and configs
are imported here: its ``launch.dryrun`` sets ``XLA_FLAGS`` for the whole
process at import, so it is never imported in a test process.
"""

import dataclasses
import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from _torch_lm import no_activation_sharder  # noqa: F401 (fixture)
from _torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

from repro.configs import get_config as jax_get_config
from repro.launch import roofline as jax_roofline
from repro.launch import shapes as jax_shapes
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.shapes import SHAPES
from repro_torch.models import attention
from repro_torch.tree import tree_leaves

pytestmark = pytest.mark.usefixtures("no_activation_sharder")

ROOT = Path(__file__).resolve().parent.parent
SIZES = [False, True]                  # published, reduced


# -- count_params and model_flops ---------------------------------------------


@pytest.mark.parametrize("smoke", SIZES)
@pytest.mark.parametrize("arch", ARCHS)
def test_count_params_matches_reference(arch, smoke):
    cfg, jcfg = get_config(arch, smoke=smoke), jax_get_config(arch,
                                                              smoke=smoke)
    for active in (False, True):
        assert roofline.count_params(cfg, active_only=active) == \
            jax_roofline.count_params(jcfg, active_only=active)


@pytest.mark.parametrize("smoke", SIZES)
@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_matches_reference_at_every_shape(arch, smoke):
    cfg, jcfg = get_config(arch, smoke=smoke), jax_get_config(arch,
                                                              smoke=smoke)
    assert list(SHAPES) == list(jax_shapes.SHAPES)
    for name, shape in SHAPES.items():
        jshape = jax_shapes.SHAPES[name]
        assert roofline.model_flops(cfg, shape, shape.kind) == \
            jax_roofline.model_flops(jcfg, jshape, jshape.kind)


@pytest.mark.parametrize("smoke", SIZES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_is_within_2_percent_of_the_meta_tree(arch, smoke):
    cfg = get_config(arch, smoke=smoke)
    actual = sum(x.numel() for x in tree_leaves(dryrun.meta_params(cfg)))
    est = roofline.count_params(cfg)
    assert abs(actual - est) / actual < 0.02, (actual, est)


# -- the H100 constants -------------------------------------------------------


def test_h100_constants_and_roofline_terms():
    """H100 SXM data-sheet peaks; the terms divide by them as the
    reference's divide by the v5e's, and ``row()`` has its keys."""
    assert (roofline.PEAK_FLOPS, roofline.PEAK_FLOPS_F32,
            roofline.PEAK_FLOPS_F64) == (989e12, 67e12, 34e12)
    assert (roofline.HBM_BW, roofline.NVLINK_BW) == (3.35e12, 450e9)
    coll = {k: 0 for k in roofline.COLLECTIVES}
    coll["all-reduce"] = 450e9
    rl = roofline.Roofline(flops=989e12, bytes_hbm=2 * 3.35e12, coll=coll,
                           chips=4, model_flops=4 * 494.5e12)
    assert (rl.t_compute, rl.t_memory, rl.t_collective) == (1.0, 2.0, 1.0)
    assert rl.bottleneck == "memory" and rl.useful_ratio == 0.5
    want = jax_roofline.Roofline(flops=1.0, bytes_hbm=1.0, coll={
        k: 0 for k in jax_roofline._COLLECTIVES}, chips=1).row()
    assert list(rl.row()) == list(want)


def test_chip_smoke_reads_its_bounds_from_roofline(monkeypatch):
    """``chip_smoke.bound`` takes HBM's rate and the peaks from
    ``launch/roofline.py``: one source."""
    sys.path.insert(0, str(ROOT))
    try:
        smoke = importlib.import_module("chip_smoke")
    finally:
        sys.path.remove(str(ROOT))
    assert smoke.bound(3.35e12, {"bf16": 989e12}) == (1000.0, "bytes")
    monkeypatch.setattr(roofline, "HBM_BW", 1.675e12)
    assert smoke.bound(3.35e12, {}) == (2000.0, "bytes")
    monkeypatch.setitem(roofline.PEAK_FLOPS_BY_DTYPE, "f32", 1e12)
    assert smoke.bound(0, {"f32": 3e12}) == (3000.0, "operations")
    text = (ROOT / "chip_smoke.py").read_text()
    assert "3.35e12" not in text and "989e12" not in text


# -- the counting mode --------------------------------------------------------


def test_cost_mode_counts_one_gemm():
    """(64, 32) @ (32, 16) in bf16: 2 * 64 * 32 * 16 = 65,536 FLOPs; it
    reads 64 * 32 + 32 * 16 and writes 64 * 16 elements of 2 bytes:
    7,168 bytes."""
    a = torch.empty((64, 32), dtype=torch.bfloat16, device="meta")
    b = torch.empty((32, 16), dtype=torch.bfloat16, device="meta")
    with dryrun.CostMode() as mode:
        a @ b
    assert (mode.flops, mode.bytes, mode.ops) == (65536, 7168, 1)


def test_cost_mode_counts_one_causal_attention_call():
    """K9 on q (2, 8, 4, 16), k, v (2, 8, 2, 16) in bf16: 8 * 9 / 2 = 36
    causal (query, key) pairs a head, 4 * 16 FLOPs each (two products of
    a multiply-add): 2 * 4 * 36 * 64 = 18,432 FLOPs; q and the output
    2 * 8 * 4 * 16 elements, k and v 2 * 8 * 2 * 16, 2 bytes each: 6,144
    bytes. With a window of 3: 3 * 4 / 2 + 5 * 3 = 21 pairs, 10,752
    FLOPs."""
    q = torch.empty((2, 8, 4, 16), dtype=torch.bfloat16, device="meta")
    k = torch.empty((2, 8, 2, 16), dtype=torch.bfloat16, device="meta")
    mode = dryrun.CostMode()
    with dryrun.kernels_counted(mode), mode:
        out = attention.flash_attention(q, k, k)
    assert out.shape == q.shape and out.device.type == "meta"
    assert (mode.flops, mode.bytes) == (18432, 6144)
    mode = dryrun.CostMode()
    with dryrun.kernels_counted(mode), mode:
        attention.flash_attention(q, k, k, window=3)
    assert mode.flops == 10752
    # the stand-ins are gone after the block
    assert attention.flash_attention.__module__.endswith("flash_attention.ops")


def test_cost_mode_counts_the_plain_masked_attention():
    """``_sdpa`` (T <= 512) computes every score under the mask: all 8 * 8
    (query, key) pairs of each of 2 * 4 heads, through two products of 16
    multiply-adds a pair: 2 * 2 * 16 * 64 * 8 = 32,768 FLOPs, the full
    square where K9 visits the causal half."""
    q = torch.empty((2, 8, 4, 16), dtype=torch.float32, device="meta")
    k = torch.empty((2, 8, 2, 16), dtype=torch.float32, device="meta")
    mask = torch.empty((8, 8), dtype=torch.bool, device="meta")
    with dryrun.CostMode() as mode:
        attention._sdpa(q, k, k, mask, 2)
    assert mode.flops == 32768


def test_attention_pairs():
    assert dryrun.attention_pairs(8) == 36
    assert dryrun.attention_pairs(8, window=3) == 21
    assert dryrun.attention_pairs(8, window=8) == 36


@pytest.mark.parametrize("arch,kind", [("qwen2-0.5b", "train_4k"),
                                       ("jamba-1.5-large-398b", "train_4k"),
                                       ("whisper-tiny", "decode_32k"),
                                       ("qwen2-0.5b", "prefill_32k")])
def test_period_probes_give_the_full_count(arch, kind):
    """A reduced model of 10 layers (whisper with 10 encoder layers too)
    counted every layer equals the quadratic through its 2-, 3- and
    4-period probes, FLOPs, bytes and ops, at B = 2, T <= 1,024."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), n_layers=10)
    if cfg.enc_layers:
        cfg = dataclasses.replace(cfg, enc_layers=10)
    shape = dataclasses.replace(SHAPES[kind], global_batch=2,
                                seq_len=min(SHAPES[kind].seq_len, 1024))
    model = dryrun.build_model(cfg)
    got, how = dryrun._probe_costs(cfg, shape, "adamw", model)
    assert how == "probe-extrapolated" and model.n_segments >= 5
    assert got == dryrun.count_step(cfg, shape)


@pytest.mark.parametrize("kind", ["train_4k", "prefill_32k"])
def test_length_probes_give_the_full_count(kind):
    """Reduced xlstm (chunk 32) at T = 192: the quadratic through T = 64,
    96 and 128 equals the count of every step of the sLSTM's loop."""
    cfg = get_config("xlstm-350m", smoke=True)
    shape = dataclasses.replace(SHAPES[kind], global_batch=4, seq_len=192)
    assert dryrun.length_probe(cfg, shape) == 32
    assert dryrun.count_step_probed(cfg, shape) == dryrun.count_step(cfg,
                                                                     shape)


# -- collective bytes ---------------------------------------------------------


def test_collective_bytes_of_a_two_leaf_tree():
    """On {data 2, model 4}, a batch of 8 x 16 tokens (64 a data rank):
    ``embed`` (64, 32) bf16 is split ("model", "data"): 512 bytes a card,
    all-gathered and its gradient reduce-scattered over data, 512 * (2 -
    1) each; a stacked ``wo`` (2, 32, 32) bf16 is split (None, "model",
    "data") the same way, 512 more each, and its rows over "model" leave
    partial sums: per layer 64 tokens x 32 x 2 bytes = 4,096, all-reduced
    at 2 (4 - 1) / 4, 2 layers, 3 passes in training: 36,864 bytes."""
    params = {"embed": torch.empty((64, 32), dtype=torch.bfloat16,
                                   device="meta"),
              "layers": [{"mixer": {"wo": torch.empty(
                  (2, 32, 32), dtype=torch.bfloat16, device="meta")}}]}
    batch = {"tokens": torch.empty((8, 16), dtype=torch.int32,
                                   device="meta")}
    ext = {"data": 2, "model": 4}
    got = roofline.collective_bytes(params, batch, ext, "train")
    assert got == {"all-gather": 1024, "all-reduce": 36864,
                   "reduce-scatter": 1024, "all-to-all": 0,
                   "collective-permute": 0}
    got = roofline.collective_bytes(params, batch, ext, "prefill")
    assert got["all-gather"] == 1024 and got["reduce-scatter"] == 0
    assert got["all-reduce"] == 36864 // 3
    # a replicated leaf's gradient is all-reduced over the batch axes
    norm = {"norm_f": {"w": torch.empty((32,), dtype=torch.float32,
                                        device="meta")}}
    assert roofline.collective_bytes(norm, batch, ext)["all-reduce"] == 128


# -- dryrun_pair --------------------------------------------------------------


# the reference's row keys (src/repro/launch/dryrun.py, ``dryrun_pair``),
# without its roofline's, which come from ``Roofline.row``
ROW_KEYS = ["arch", "shape", "mesh", "status", "kind", "optimizer",
            "cost_mode", "lower_s", "compile_s", "argument_bytes",
            "output_bytes", "temp_bytes", "peak_bytes_per_device"]


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_dryrun_pair_rows_on_the_meta_device(arch, shape):
    """Every reduced pair on the 16 x 16 extents: ``ok`` with positive
    counts and the reference's keys, or the reference's ``skip`` and
    reason."""
    row = dryrun.dryrun_pair(arch, shape, smoke=True, verbose=False)
    reason = jax_shapes.skip_reason(jax_get_config(arch, smoke=True),
                                    jax_shapes.SHAPES[shape])
    if reason:
        assert row == {"arch": arch, "shape": shape, "status": "skip",
                       "reason": reason}
        return
    rl_keys = list(jax_roofline.Roofline(
        flops=1.0, bytes_hbm=1.0, coll={k: 0 for k in
                                        jax_roofline._COLLECTIVES},
        chips=1).row())
    assert set(ROW_KEYS + rl_keys) <= set(row), set(ROW_KEYS + rl_keys) - set(row)
    assert row["status"] == "ok" and row["mesh"] == "16x16"
    assert row["flops"] > 0 and row["bytes"] > 0
    assert row["argument_bytes"] > 0 and row["peak_bytes_per_device"] == (
        row["argument_bytes"] + row["temp_bytes"])
    assert (row["temp_bytes"] > 0) == (row["kind"] != "decode")
    assert 0 < row["useful_ratio"] < 1.5
    assert json.loads(json.dumps(row)) == row


def test_dryrun_cli_appends_rows(tmp_path):
    """``main`` with the reference's flags and ``--smoke``: one JSON line
    a pair, exit 0."""
    out = tmp_path / "rows.jsonl"
    with pytest.raises(SystemExit) as done:
        dryrun.main(["--arch", "granite-moe-1b-a400m", "--shape",
                     "decode_32k", "--smoke", "--multi-pod", "--out",
                     str(out), "--microbatches", "4"])
    assert done.value.code == 0
    row, = [json.loads(line) for line in out.read_text().splitlines()]
    assert row["status"] == "ok" and row["mesh"] == "2x16x16"


def test_dryrun_imports_no_jax_and_makes_no_process_group():
    """The port's roofline and dry run in a fresh process: a pair runs on
    the meta device with no JAX module loaded and no process group."""
    code = ("import sys, torch.distributed as dist\n"
            "from repro_torch.launch import dryrun, roofline\n"
            "row = dryrun.dryrun_pair('qwen2-0.5b', 'decode_32k', smoke=True,"
            " verbose=False)\n"
            "assert row['status'] == 'ok', row\n"
            "assert not dist.is_initialized()\n"
            "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))"
            " or m == 'repro' for m in sys.modules), 'jax loaded'\n"
            "print('OK')\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.stdout.strip() == "OK", out.stderr[-2000:]
