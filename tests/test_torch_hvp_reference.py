"""Hutchinson's Hz on one process against the reference (the checks of
``tests/_torch_hvp.py``) for the MoE family (granite-moe-1b-a400m: the
router's top-k and the experts' dispatch under the double backward) and
the VLM (llava-next-34b: its patches before the tokens), each family's
reduced config in f32. The dense family is held by
``test_torch_train.py``; MLA by ``test_torch_hvp_reference_attention.py``,
whisper by ``test_torch_hvp_reference_encdec.py``, jamba by
``test_torch_hvp_reference_hybrid.py``, xLSTM by
``test_torch_hvp_reference_xlstm.py``.

Tolerances: ``_torch_hvp.py``'s (each leaf within 1e-4 of its largest
|value| of the reference's; the step's loss within 1e-5 relative).
"""

import pytest

from _torch_hvp import check_hz, check_step, no_activation_sharder  # noqa: F401
from _torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

ARCHS = ["granite-moe-1b-a400m", "llava-next-34b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_hz_matches_jvp_of_grad(arch):
    check_hz(arch, 64)


@pytest.mark.parametrize("arch", ARCHS)
def test_hvp_step_matches_the_reference_jitted_step(arch):
    check_step(arch)
