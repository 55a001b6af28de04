"""Hutchinson curvature (``hvp``) over the mesh's "model" axis for xLSTM,
the encoder-decoder and the VLM, as ``test_torch_hvp_axis.py`` holds the
dense and MoE families, at reduced widths:

* xlstm-350m with d_ff 0 (no MLP, as the published config) at d 256: an
  mLSTM (its 4 heads split at M = 2 and 4) and an sLSTM (its recurrence
  on every rank, its weights taken whole);
* whisper-tiny with 6 heads at d 192 (d_ff 256): M = 2 splits the heads
  of the encoder, the decoder and the cross-attention, M = 4 takes
  ``q_whole`` (every head on every rank);
* llava-next-34b at d 128 (d_ff 256), 16 patches before the tokens.

The checks and their tolerances are ``tests/_torch_hvp_axis.py``'s.
"""

import pytest

from _torch_hvp_axis import (SHAPES, check_hz, check_refresh, check_steps,
                             check_z, finish, one_process, start)
from _torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

SIX_HEADS = dict(n_heads=6, kv_heads=6, head_dim=32)
CONFIGS = [("xlstm", "xlstm-350m", dict(d_ff=0), None),
           ("whisper_6_heads", "whisper-tiny", dict(d_model=192, d_ff=256),
            SIX_HEADS),
           ("llava", "llava-next-34b", dict(d_model=128, d_ff=256), None)]
CASES = [(shape, c) for shape in SHAPES for c in range(len(CONFIGS))]


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    return finish(start(tmp_path_factory, CONFIGS, "hvp_ssm"), CONFIGS)


@pytest.mark.parametrize("shape,case", CASES)
def test_each_rank_probes_its_block_of_one_process_z(shape, case, groups):
    check_z(groups[shape]["runs"][case], one_process(CONFIGS[case], shape[0]), shape)


@pytest.mark.parametrize("shape,case", CASES)
def test_hz_follows_one_process(shape, case, groups):
    check_hz(groups[shape]["runs"][case], one_process(CONFIGS[case], shape[0]),
             shape)


@pytest.mark.parametrize("shape,case", CASES)
def test_refresh_of_the_same_observations_is_one_process(shape, case,
                                                         groups):
    check_refresh(groups[shape]["runs"][case], shape)


@pytest.mark.parametrize("shape,case", CASES)
def test_four_hvp_steps_follow_one_process(shape, case, groups):
    check_steps(groups[shape]["runs"][case], one_process(CONFIGS[case], shape[0]))
