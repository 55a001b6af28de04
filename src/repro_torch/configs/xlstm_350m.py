"""xLSTM-350M [arXiv:2405.04517].

24 layers, d_model 1024, 4 heads, vocab 50304, d_ff 0 (the xLSTM block
carries its own projections: no feed-forward); mLSTM : sLSTM = 7 : 1.
Recurrent state decode: O(1) a token, so it runs the long_500k shape.
"""

from __future__ import annotations

from . import ModelConfig, XLSTMConfig, model_param_shapes

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    kv_heads=4,
    d_ff=0,
    vocab=50304,
    rope=False,
    xlstm=XLSTMConfig(slstm_every=8, chunk=256),
    norm="rmsnorm",
    source="[arXiv:2405.04517]",
)


def param_shapes(cfg: ModelConfig = CONFIG) -> dict:
    """The parameter tree of the reference's ``init_params`` for this
    model, as ``ParamShape`` leaves (``model_param_shapes``): 241.7 M
    parameters (no MLP), one stack per position of the 8-block period."""
    return model_param_shapes(cfg)
