"""Hutchinson's Hz on one process against the reference (the checks of
``tests/_torch_hvp.py``) for the encoder-decoder: reduced whisper-tiny in
f32, the encoder and the decoder's cross-attention over its frames under
the double backward.

Tolerances: ``_torch_hvp.py``'s (each leaf within 1e-4 of its largest
|value| of the reference's; the step's loss within 1e-5 relative).
"""

from _torch_hvp import check_hz, check_step, no_activation_sharder  # noqa: F401
from _torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

WHISPER = "whisper-tiny"


def test_hz_matches_jvp_of_grad():
    check_hz(WHISPER, 64)


def test_hvp_step_matches_the_reference_jitted_step():
    check_step(WHISPER)
