"""The model axis's operators differentiated twice, on a 2-rank gloo group
(``tests/_torch_dist.py``), in f64: each case of ``HVP_OP_CASES`` is a
function of tensors held whole on every rank to one held whole, through
one or more operators (``_torch_dist.hvp_op_function``):

* ``copy_in_reduce_out``: Megatron's MLP pair, tanh(x W1) W2 with W1's
  columns and W2's rows split (``split_on``);
* ``split_on_gather_on``: tanh(x W) on a rank's columns, gathered;
* ``gather_weight``: a rank's rows of x times W gathered whole from its
  column shards (backward ``_SumPart``, the reduce-scatter);
* ``sum_part``: ``_SumPart`` itself, sum_r tanh(c_r x) with each rank's
  own c_r (backward ``_GatherWeight``);
* ``vocab_parallel_cross_entropy``: the loss over a vocab split in two
  (its max shift under ``no_grad``, its sums through ``reduce_out``).

Each is held by ``torch.autograd.gradgradcheck`` on every rank (its own
tolerances: the analytic double backward against finite differences of
the backward), and its value, its gradient with an output gradient u and
the double backward of that gradient's product with v against the same
function computed whole in this process, within 1e-12 of each tensor's
largest |value| (f64, the ranks' sums in another order). Every rank holds
the same value, gradient and double backward, bit for bit.
"""

import numpy as np
import pytest
import torch

from _torch_dist import hvp_ops, run_group
from _torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)
from repro_torch.models.common import cross_entropy

RANKS, C = 2, (0.7, -1.3)
REL = 1e-12


def _whole(name: str, targets=None):
    if name in ("copy_in_reduce_out",):
        return lambda x, w1, w2: torch.tanh(x @ w1) @ w2
    if name in ("split_on_gather_on", "gather_weight"):
        return lambda x, w: torch.tanh(x @ w)
    if name == "sum_part":
        return lambda x: sum(torch.tanh(c * x) for c in C)
    if name == "vocab_parallel_cross_entropy":
        return lambda logits: cross_entropy(logits, targets)
    raise ValueError(name)


# name -> (input shapes, output shape)
SHAPES = {"copy_in_reduce_out": ([(4, 6), (6, 8), (8, 6)], (4, 6)),
          "split_on_gather_on": ([(3, 4), (4, 6)], (3, 6)),
          "gather_weight": ([(4, 4), (4, 6)], (4, 6)),
          "sum_part": ([(4, 3)], (4, 3)),
          "vocab_parallel_cross_entropy": ([(2, 3, 8)], ())}


def _cases():
    rng = np.random.default_rng(5)
    out = []
    for name, (ins, y) in SHAPES.items():
        inputs = [rng.standard_normal(s) for s in ins]
        u = rng.standard_normal(y)
        v = [rng.standard_normal(s) for s in ins]
        targets = (rng.integers(0, 8, (2, 3))
                   if name == "vocab_parallel_cross_entropy" else None)
        out.append((name, inputs, u, v, targets))
    return out


@pytest.fixture(scope="module")
def got(tmp_path_factory):
    return run_group(hvp_ops, RANKS, tmp_path_factory.mktemp("hvp_ops"),
                     _cases())


def _close(a: torch.Tensor, b: torch.Tensor) -> None:
    scale = float(b.abs().max()) or 1.0
    assert float((a - b).abs().max()) <= REL * scale


@pytest.mark.parametrize("case", range(len(SHAPES)))
def test_each_operator_is_twice_differentiable(case, got):
    name, inputs, u, v, targets = _cases()[case]
    rec = got[name]
    assert rec["gradgradcheck"] is True
    assert rec["ranks_equal"]
    fn = _whole(name, None if targets is None else torch.from_numpy(targets))
    xs = [torch.from_numpy(x).requires_grad_(True) for x in inputs]
    y = fn(*xs)
    g = torch.autograd.grad(y, xs, grad_outputs=torch.from_numpy(u),
                            create_graph=True)
    hv = torch.autograd.grad(g, xs, grad_outputs=[torch.from_numpy(w)
                                                  for w in v])
    _close(rec["y"], y.detach())
    for a, b in zip(rec["g"], g):
        _close(a, b.detach())
    for a, b in zip(rec["hv"], hv):
        assert float(b.abs().max()) > 0
        _close(a, b)
