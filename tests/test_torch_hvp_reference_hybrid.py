"""Hutchinson's Hz on one process against the reference (the checks of
``tests/_torch_hvp.py``) for the hybrid family: reduced
jamba-1.5-large-398b, one period (Mamba + MLP, GQA + a 4-expert MoE) in
f32. Hz at T = 300, where the Mamba scan runs over two chunks of 256,
padded, each under ``checkpoint``, inside the layer's remat; the step at
T = 32, one chunk.

Tolerances: ``_torch_hvp.py``'s (each leaf within 1e-4 of its largest
|value| of the reference's; the step's loss within 1e-5 relative).
"""

from _torch_hvp import check_hz, check_step, no_activation_sharder  # noqa: F401
from _torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

JAMBA = "jamba-1.5-large-398b"


def test_hz_matches_jvp_of_grad():
    check_hz(JAMBA, 300)


def test_hvp_step_matches_the_reference_jitted_step():
    check_step(JAMBA)
