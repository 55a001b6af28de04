"""Token data for the LM train and serve steps, counterpart of
``src/repro/data/tokens.py``.

A synthetic corpus with learnable structure: Zipfian unigrams drawn by
inverse CDF on a power law, with short motifs pasted at random offsets
(uniform noise would make optimizer comparisons meaningless); targets
are the tokens rolled by one. Deterministic per (seed, step), from a CPU
``torch.Generator`` seeded from the pair, with no file behind it. The
leading axis is the global batch, which the train step splits into
microbatches and silos. The draws differ from the reference's
``jax.random`` ones; the structure is the same.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..device import resolve_device


def _generator(*words: int) -> torch.Generator:
    mixed = np.random.SeedSequence([int(w) for w in words])
    return torch.Generator().manual_seed(
        int(mixed.generate_state(1, np.uint64)[0]) >> 1)


@dataclasses.dataclass(frozen=True)
class TokenPipeline:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    motif_len: int = 16
    num_motifs: int = 256

    def motifs(self) -> torch.Tensor:
        """(num_motifs, motif_len) int32 motifs, fixed by the seed."""
        return torch.randint(0, self.vocab_size,
                             (self.num_motifs, self.motif_len),
                             generator=_generator(self.seed),
                             dtype=torch.int32)

    def batch(self, step: int, device=None) -> dict:
        """{'tokens': (B, T) int32, 'targets': (B, T) int32} of ``step``,
        on ``device`` (the card unless asked)."""
        gen = _generator(self.seed, 1, step)
        b, t = self.global_batch, self.seq_len
        u = torch.rand((b, t), generator=gen, dtype=torch.float32)
        u = 1e-6 + u * (1.0 - 1e-6)
        ranks = torch.floor(torch.exp(u * math.log(float(self.vocab_size))))
        tokens = (ranks - 1.0).to(torch.int32) % self.vocab_size
        which = torch.randint(0, self.num_motifs, (b,), generator=gen)
        offs = torch.randint(0, max(1, t - self.motif_len), (b,),
                             generator=gen)
        idx = offs[:, None] + torch.arange(self.motif_len)
        keep = idx < t
        rows = torch.arange(b)[:, None].expand_as(idx)
        tokens[rows[keep], idx[keep]] = self.motifs()[which][keep]
        targets = torch.roll(tokens, -1, dims=-1)
        dev = resolve_device(device)
        return {"tokens": tokens.to(dev), "targets": targets.to(dev)}
