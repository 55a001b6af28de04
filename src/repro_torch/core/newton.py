"""Classical Newton on the averaged problem — what ``make_problem`` runs
to find x* (counterpart of ``newton_step``/``newton_run`` in
``repro.core.newton``)."""

from __future__ import annotations

import torch

from .linalg import solve_newton_system


def newton_step(x, grad_fn, hess_fn):
    g = torch.mean(grad_fn(x), dim=0)
    h = torch.mean(hess_fn(x), dim=0)
    return x - solve_newton_system(h, g)


def newton_run(x0, grad_fn, hess_fn, num_rounds: int):
    """Returns (x after ``num_rounds`` steps, (num_rounds + 1, d)
    iterate history with x0 first)."""
    xs = [x0]
    x = x0
    for _ in range(num_rounds):
        x = newton_step(x, grad_fn, hess_fn)
        xs.append(x)
    return x, torch.stack(xs)
