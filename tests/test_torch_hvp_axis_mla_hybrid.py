"""Hutchinson curvature (``hvp``) over the mesh's "model" axis for MLA
and the hybrid family, as ``test_torch_hvp_axis.py`` holds the dense and
MoE families, at reduced widths (d 128, d_ff 256, vocab 512):

* minicpm3-4b with 4 heads (kv_lora 32): its heads split at M = 2 and 4,
  ``wuk``/``wuv`` on their 32 latent rows;
* jamba-1.5-large-398b, one period (Mamba + MLP, GQA + a 4-expert MoE,
  expert parallel): the Mamba mixer's Di channels over "model", its scan
  under ``checkpoint`` in the double backward.

The checks and their tolerances are ``tests/_torch_hvp_axis.py``'s.
"""

import pytest

from _torch_hvp_axis import (SHAPES, check_hz, check_refresh, check_steps,
                             check_z, finish, one_process, start)
from _torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

NARROW = dict(d_model=128, d_ff=256)
CONFIGS = [("minicpm3", "minicpm3-4b", NARROW, None),
           ("jamba", "jamba-1.5-large-398b", NARROW, None)]
CASES = [(shape, c) for shape in SHAPES for c in range(len(CONFIGS))]


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    return finish(start(tmp_path_factory, CONFIGS, "hvp_mla"), CONFIGS)


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
