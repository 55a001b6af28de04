"""Prefill and serve steps shared by the server and the smoke run, the
counterparts of ``make_prefill`` and ``make_serve_step`` in
``src/repro/launch/steps.py``.

``make_prefill``     : (params, batch) -> logits
``make_serve_step``  : (params, cache, token, pos) -> (logits, cache)

PyTorch runs eagerly, so a step is the model call itself (the reference
jits it). ``make_train_step`` waits for the training slice.
"""

from __future__ import annotations

import torch

from ..models import Model


def make_prefill(model: Model):
    @torch.no_grad()
    def prefill(params, batch):
        logits, _ = model.forward(params, batch)
        return logits

    return prefill


def make_serve_step(model: Model):
    @torch.no_grad()
    def serve_step(params, cache, token, pos):
        return model.decode_step(params, cache, token, pos)

    return serve_step
