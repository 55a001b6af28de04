"""Roofline terms of a step on the H100, the counterpart of
``src/repro/launch/roofline.py`` (whose constants are a TPU's):

  compute term    = FLOPs / (chips * 989e12 bf16 FLOP/s)
  memory term     = bytes / (chips * 3.35e12 B/s HBM)
  collective term = collective bytes / (chips * 450e9 B/s NVLink, one way)

FLOPs and bytes come from ``launch/dryrun.py``'s count of the step's
operations on the meta device; collective bytes from the sharding rules
(``collective_bytes``), since eager PyTorch has no compiled program to
read them from. ``model_flops`` is 6 N D (dense) or 6 N_active D (MoE)
for training and 2 N D for a forward, as the reference's.

The constants are an H100 SXM's data-sheet peaks (dense, no sparsity),
the one source of every bound in this package and in ``chip_smoke.py``.
"""

from __future__ import annotations

import dataclasses

from ..models.transformer import layer_kinds
from .sharding import batch_specs, param_spec

PEAK_FLOPS = 989e12       # bf16 / card (tensor cores)
PEAK_FLOPS_F32 = 67e12    # f32 / card (CUDA cores, no TF32)
PEAK_FLOPS_F64 = 34e12    # f64 / card
PEAK_FLOPS_BY_DTYPE = {"bf16": PEAK_FLOPS, "f32": PEAK_FLOPS_F32,
                       "f64": PEAK_FLOPS_F64}
HBM_BW = 3.35e12          # B/s / card
NVLINK_BW = 450e9         # B/s / card, each direction

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

_BATCH_AXES = ("pod", "data")


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _extent(ext: dict, axes) -> int:
    out = 1
    for a in axes:
        out *= int(ext.get(a, 1))
    return out


def _numel(shape) -> int:
    out = 1
    for s in shape:
        out *= int(s)
    return out


def _leaves(tree, prefix: str = "params"):
    """(path, leaf) pairs of a nested dict/list tree, paths as
    ``sharding.param_spec`` reads them; a leaf is anything with
    ``.shape`` (a tensor, a meta tensor, a ``ParamShape``)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)) and not hasattr(tree, "shape"):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def collective_bytes(params, batch, ext: dict, kind: str = "train",
                     act_itemsize: int = 2) -> dict[str, int]:
    """Per-device bytes each collective kind moves in one step on a mesh
    of extents ``ext`` ({axis: extent}), reckoned from the sharding rules
    (``param_spec`` of each leaf of ``params``, ``batch_specs`` of ``batch``;
    any leaves with ``.shape`` and ``.dtype``), ring algorithms assumed.
    With p a leaf's per-device bytes (its bytes over the extents its
    spec names) and n_b the extent of the batch axes its spec names:

    * a leaf sharded over batch axes (FSDP) is all-gathered for the
      forward, p (n_b - 1), and for training its gradient is
      reduce-scattered, p (n_b - 1);
    * for training, every other leaf's gradient is all-reduced over the
      mesh's batch axes (extent N_b): 2 (N_b - 1) / N_b p;
    * a weight whose contraction dim (its second-to-last) is split over
      "model" leaves partial sums: each layer it stacks all-reduces its
      output activation, tokens per device x its last dim x
      ``act_itemsize``, 2 (n_m - 1) / n_m of it, once a forward; training
      counts three passes (the forward, remat's recompute, and the
      backward's all-reduce of the input gradient at the matching
      column-split weight, of the same size).

    Tokens per device are the batch's tokens ("tokens"' shape) over the
    extent of the batch axes its spec names; a decode step's batch is one
    token per sequence. Experts split over "model" exchange no tokens in
    this count (the reference's MoE dispatches by einsum, not by
    all-to-all). Returns every kind of ``COLLECTIVES``."""
    out = {k: 0 for k in COLLECTIVES}
    n_batch = _extent(ext, [a for a in _BATCH_AXES if a in ext])
    n_model = int(ext.get("model", 1))
    passes = 3 if kind == "train" else 1
    tok = batch["tokens"]
    tok_spec = batch_specs({"tokens": tok}, ext)["tokens"]
    tokens = _numel(tok.shape) // _extent(ext, _axes(tok_spec[0]))
    for path, leaf in _leaves(params):
        spec = param_spec(path, tuple(leaf.shape), ext)
        named = [a for e in spec for a in _axes(e)]
        per_dev = _numel(leaf.shape) * leaf.dtype.itemsize // _extent(ext, named)
        n_b = _extent(ext, [a for a in named if a in _BATCH_AXES])
        if n_b > 1:
            out["all-gather"] += per_dev * (n_b - 1)
            if kind == "train":
                out["reduce-scatter"] += per_dev * (n_b - 1)
        elif kind == "train" and n_batch > 1:
            out["all-reduce"] += 2 * (n_batch - 1) * per_dev // n_batch
        if (n_model > 1 and len(spec) >= 2 and "model" in _axes(spec[-2])
                and path.split("/")[-1] not in ("embed", "lm_head")):
            layers = int(leaf.shape[0]) if "layers" in path else 1
            act = tokens * int(leaf.shape[-1]) * act_itemsize
            out["all-reduce"] += (passes * layers * 2 * (n_model - 1) * act
                                  // n_model)
    return out


@dataclasses.dataclass
class Roofline:
    """FLOPs, bytes and collective bytes are PER DEVICE (the dry run's
    global counts over the mesh's cards); ``model_flops`` is the GLOBAL
    analytic count."""

    flops: float
    bytes_hbm: float
    coll: dict[str, int]
    chips: int
    model_flops: float = 0.0

    @property
    def coll_bytes(self) -> int:
        return sum(self.coll.values())

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_hbm / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / NVLINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs, both per device."""
        return (self.model_flops / self.chips) / self.flops if self.flops else 0.0

    def row(self) -> dict:
        return {
            "flops": self.flops, "bytes": self.bytes_hbm,
            "coll_bytes": self.coll_bytes,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "useful_ratio": self.useful_ratio,
            **{f"bytes_{k}": v for k, v in self.coll.items()},
        }


def count_params(cfg, active_only: bool = False) -> float:
    """Analytic parameter count (embeddings included once), the
    reference's formula term for term."""
    d, ff, v = cfg.d_model, cfg.d_ff, cfg.vocab
    hd = cfg.hd
    total = v * d * (1 if cfg.tie_embeddings else 2)

    def attn_params():
        if cfg.attn_type == "mla":
            m = cfg.mla
            qd = m.qk_nope_dim + m.qk_rope_dim
            return (d * m.q_lora_rank + m.q_lora_rank * cfg.n_heads * qd
                    + d * m.kv_lora_rank + d * m.qk_rope_dim
                    + m.kv_lora_rank * cfg.n_heads * (m.qk_nope_dim + m.v_head_dim)
                    + cfg.n_heads * m.v_head_dim * d)
        return d * cfg.n_heads * hd + 2 * d * cfg.kv_heads * hd \
            + cfg.n_heads * hd * d

    def mlp_params(experts: int = 1, topk: int = 1, active: bool = False):
        per = (3 if cfg.mlp_type == "swiglu" else 2) * d * ff
        e = (topk if active else experts)
        return per * e

    for mixer, ffn in layer_kinds(cfg):
        if mixer in ("attn", "mla"):
            total += attn_params()
        elif mixer == "mamba":
            di = cfg.mamba.expand * d
            total += d * 2 * di + cfg.mamba.d_conv * di \
                + di * 2 * cfg.mamba.d_state + di + di * cfg.mamba.d_state + di * d
        elif mixer == "mlstm":
            total += 5 * d * d + d * 2 * cfg.n_heads
        elif mixer == "slstm":
            total += 9 * d * d
        if ffn == "moe":
            total += mlp_params(cfg.moe.num_experts, cfg.moe.top_k,
                                active=active_only) + d * cfg.moe.num_experts
        elif ffn == "mlp":
            total += mlp_params()
    if cfg.family == "encdec":
        for _ in range(cfg.enc_layers):
            total += attn_params() * 2 + mlp_params()  # self + cross (in dec)
    return float(total)


def model_flops(cfg, shape, kind: str) -> float:
    """6 N_active tokens for training; 2 N_active tokens for a forward or
    a decode step (one token per sequence)."""
    n_active = count_params(cfg, active_only=True)
    tokens = shape.global_batch * (shape.seq_len if kind != "decode" else 1)
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_active * tokens
