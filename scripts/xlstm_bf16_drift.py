"""How far xlstm-350m's bf16 logits fall from its f32 logits, in the JAX
reference and in the PyTorch port, at full width on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/xlstm_bf16_drift.py \
        [--batch 2] [--seq 23] [--seed 1]

Both packages run the reference's ``init_params(PRNGKey(0))`` weights
(the port's copied with ``params_from_numpy``) on the same tokens, in
f32 and in bf16. Prints, for each dtype, the port's gap to the
reference, and for each package its bf16 logits' gap to the reference's
f32 logits and their argmax agreement: the yardstick for the card's
bf16 checks of this model (about a minute and 4 GB of memory).
"""

from __future__ import annotations

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.models.transformer import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy
from repro_torch.launch.steps import make_prefill
from repro_torch.models import build_model

ARCH = "xlstm-350m"


def logits(dtype: str, toks: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(reference, port) f32 copies of the logits in ``dtype``."""
    jcfg = dataclasses.replace(jax_get_config(ARCH), dtype=dtype)
    jmodel = jax_build_model(jcfg, use_remat=False)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    want = jmodel.forward(jparams, {"tokens": jnp.asarray(toks)})[0]
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    model = build_model(dataclasses.replace(get_config(ARCH), dtype=dtype))
    got = make_prefill(model)(params, {"tokens": torch.from_numpy(toks).long()})
    return (np.asarray(want.astype(jnp.float32)),
            got.float().numpy())


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=23)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    vocab = get_config(ARCH).vocab
    toks = np.random.default_rng(args.seed).integers(
        0, vocab, (args.batch, args.seq)).astype(np.int32)
    out = {dtype: logits(dtype, toks) for dtype in ("float32", "bfloat16")}
    f32 = out["float32"][0]
    scale = float(np.abs(f32).max())
    print(f"{ARCH}, B={args.batch}, T={args.seq}; max |reference f32 "
          f"logit| {scale:.4f}")
    for dtype, (want, got) in out.items():
        print(f"{dtype}: port against reference, max gap "
              f"{float(np.abs(got - want).max()):.4g}")
    for name, x in (("reference", out["bfloat16"][0]),
                    ("port", out["bfloat16"][1])):
        gap = float(np.abs(x - f32).max())
        agree = float((x.argmax(-1) == f32.argmax(-1)).mean())
        print(f"{name} bf16 against reference f32: max gap {gap:.4g} "
              f"({gap / scale:.3f} of the largest), argmax agreement "
              f"{agree:.3f}")


if __name__ == "__main__":
    main()
