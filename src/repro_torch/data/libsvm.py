"""LibSVM text-format parsing and cross-silo partitioning, counterpart
of ``repro.data.libsvm``.

``parse_libsvm`` reads the standard ``label idx:val ...`` text (so real
files drop in where present; nothing is fetched), and
``partition_across_silos`` splits the rows evenly across n silos as the
paper's Table 3 does. Without the files, ``data.synthetic
.make_libsvm_like`` gives stand-ins of the same shapes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.objectives import LogRegData
from ..device import resolve_device


def parse_libsvm(text: str, d: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Parse LibSVM text into dense (N, d) features and (N,) +-1 labels
    (f32 numpy, as the reference)."""
    rows = []
    labels = []
    max_idx = 0
    for line in text.strip().splitlines():
        parts = line.split()
        if not parts:
            continue
        y = float(parts[0])
        feats = {}
        for tok in parts[1:]:
            if ":" not in tok:
                continue
            i, v = tok.split(":")
            i = int(i)
            feats[i] = float(v)
            max_idx = max(max_idx, i)
        labels.append(-1.0 if y <= 0 else 1.0)
        rows.append(feats)
    dim = d if d is not None else max_idx
    a = np.zeros((len(rows), dim), np.float32)
    for r, feats in enumerate(rows):
        for i, v in feats.items():
            if i <= dim:
                a[r, i - 1] = v
    return a, np.asarray(labels, np.float32)


def partition_across_silos(a: np.ndarray, b: np.ndarray, n: int,
                           lam: float = 1e-3, device=None,
                           dtype: torch.dtype = torch.float64) -> LogRegData:
    """Even, contiguous partition into n silos of m = floor(N/n) points
    (rows beyond n*m are dropped, matching Table 3's nm counts), as
    tensors of ``dtype`` on ``device`` (the card unless asked)."""
    m = a.shape[0] // n
    a_s = a[: n * m].reshape(n, m, a.shape[1])
    b_s = b[: n * m].reshape(n, m)
    dev = resolve_device(device)
    return LogRegData(a=torch.from_numpy(a_s).to(device=dev, dtype=dtype),
                      b=torch.from_numpy(b_s).to(device=dev, dtype=dtype),
                      lam=lam)
