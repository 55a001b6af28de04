"""Hutchinson's Hz on one process against the reference (the checks of
``tests/_torch_hvp.py``) for MLA: reduced minicpm3-4b in f32, at T = 64
and at T = 600, where its query chunks run under ``checkpoint`` in the
double backward.

Tolerances: ``_torch_hvp.py``'s (each leaf within 1e-4 of its largest
|value| of the reference's; the step's loss within 1e-5 relative).
"""

import pytest

from _torch_hvp import check_hz, check_step, no_activation_sharder  # noqa: F401
from _torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

MINICPM3 = "minicpm3-4b"


@pytest.mark.parametrize("t", [64, 600])
def test_hz_matches_jvp_of_grad(t):
    check_hz(MINICPM3, t)


def test_hvp_step_matches_the_reference_jitted_step():
    check_step(MINICPM3)
