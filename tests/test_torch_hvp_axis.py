"""Hutchinson curvature (``hvp``) over the mesh's "model" axis for the
dense and MoE families, on gloo groups of spawned CPU ranks (one group a
mesh shape: (1, 2), (1, 4) and (2, 2)), through the train driver
(``launch.train.main(... --hvp)``, so ``make_train_step(hvp=True,
mesh=)``) against one process, at reduced widths:

* qwen2-0.5b (4 heads over 2 KV heads: at M = 4 the KV heads do not
  split);
* granite-moe-1b-a400m with 4 experts (expert parallel at M = 2 and 4)
  and a vocab of 515, which no extent divides (the embedding replicated).

The checks and their tolerances are ``tests/_torch_hvp_axis.py``'s: z
and the refresh from the same observations bit for bit, Hz within 1e-4
of each leaf's largest |value|, four steps' losses within 1e-5
relative. Last, ``tools/mesh_train_check.py --hvp`` on the (1, 4) group.
"""

import pytest

from _torch_hvp_axis import (SHAPES, check_hz, check_refresh, check_steps,
                             check_z, finish, one_process, start)
from _torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

CONFIGS = [("qwen2", "qwen2-0.5b", {}, None),
           ("granite_ep", "granite-moe-1b-a400m",
            dict(d_model=128, d_ff=256, vocab=515), None)]
CASES = [(shape, c) for shape in SHAPES for c in range(len(CONFIGS))]


# ``tools/mesh_train_check.py --hvp`` on the (1, 4) group
TOOL_ARGV = ["--device", "cpu", "--smoke", "--data", "1", "--model", "4",
             "--steps", "2", "--hvp"]


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    return finish(start(tmp_path_factory, CONFIGS, "hvp",
                        {(1, 4): TOOL_ARGV}), CONFIGS)


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


def test_the_mesh_check_tool_runs_hutchinson_curvature(groups):
    """``tools/mesh_train_check.py --hvp --device cpu --smoke --data 1
    --model 4``: the driver's hvp steps over the mesh against one process,
    losses within the tool's ``LOSS_REL``."""
    rec = groups[(1, 4)]["tool"]
    out = rec["json"]
    assert rec["code"] == 0 and out["ok"] and out["hvp"]
    assert out["mesh"] == {"data": 1, "model": 4}
    assert out["losses_finite"] and out["loss_rel_max"] <= 1e-2
    assert out["refreshed"] == [True, False]
