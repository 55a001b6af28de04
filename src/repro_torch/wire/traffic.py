"""Traffic model: payload bytes x link distributions -> seconds/round,
a copy of ``repro.wire.traffic`` (host numpy: every number equals the
reference's bit for bit).

The codec (``repro_torch.wire.codec``) turns payloads into byte
buffers; this module turns byte buffers into *time*, so sweeps can rank
methods by simulated wall-clock per round instead of bits alone. The
model is the standard synchronous-FL round shape: every participating
silo uploads its payload over its own link, the server waits for the
slowest (straggler-dominated — the ``max`` reduction), and per-silo
links are heterogeneous (lognormal bandwidth spread around the preset mean,
uniform latency jitter), which is what makes the cohort size ``n``
matter: a bigger cohort samples deeper into the slow tail.

Everything is deterministic given ``seed`` (numpy Generator), so the
``seconds_per_round`` column in sweep records is reproducible.

Presets (README "wire format" section documents the table):

  ``datacenter``       10 Gbit/s, 0.5 ms — intra-DC silos (FedNL's
                       cross-silo setting at its friendliest)
  ``wan``              100 Mbit/s, 25 ms — cross-region silos; the
                       default for sweep records
  ``fl-cross-device``  20 Mbit/s, 50 ms, heavy lognormal spread —
                       phone-class uplinks (the "Unlocking FedNL"
                       practical tier)

Use ``round_seconds(bits, link, n)`` for one round of an n-silo cohort,
or ``LinkModel(...)`` directly for custom links.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np


@dataclasses.dataclass(frozen=True)
class LinkModel:
    """One uplink class.

    bandwidth_bps:   mean uplink bandwidth, bits/second (the lognormal
                     per-silo draw is mean-corrected, so the *average*
                     silo sees exactly this)
    latency_s:       fixed per-message latency, seconds
    bandwidth_sigma: lognormal sigma of the per-silo bandwidth spread
                     (0 = every silo identical)
    latency_jitter_s: half-width of uniform latency jitter
    """

    name: str
    bandwidth_bps: float
    latency_s: float
    bandwidth_sigma: float = 0.0
    latency_jitter_s: float = 0.0

    def silo_bandwidths(self, n: int, seed: int = 0) -> np.ndarray:
        """(n,) per-silo bandwidth draws, mean-corrected lognormal."""
        if self.bandwidth_sigma <= 0.0:
            return np.full(n, float(self.bandwidth_bps))
        rng = np.random.default_rng(seed)
        # E[lognormal(mu, s)] = exp(mu + s^2/2); pick mu so the mean is 1
        s = float(self.bandwidth_sigma)
        draw = rng.lognormal(mean=-0.5 * s * s, sigma=s, size=n)
        return self.bandwidth_bps * draw

    def silo_seconds(self, bits_per_silo: float, n: int,
                     seed: int = 0) -> np.ndarray:
        """(n,) per-silo upload times for one round: latency (+ jitter)
        plus transfer time at each silo's drawn bandwidth."""
        bw = self.silo_bandwidths(n, seed=seed)
        lat = np.full(n, float(self.latency_s))
        if self.latency_jitter_s > 0.0:
            rng = np.random.default_rng(seed + 1)
            lat = lat + rng.uniform(0.0, self.latency_jitter_s, size=n)
        return lat + float(bits_per_silo) / bw


#: named link presets — ``link_model("wan")`` etc.; the README documents
#: this table next to the measured wire sizes
PRESETS = {
    "datacenter": LinkModel("datacenter", bandwidth_bps=10e9,
                            latency_s=0.0005, bandwidth_sigma=0.1,
                            latency_jitter_s=0.0002),
    "wan": LinkModel("wan", bandwidth_bps=100e6, latency_s=0.025,
                     bandwidth_sigma=0.5, latency_jitter_s=0.005),
    "fl-cross-device": LinkModel("fl-cross-device", bandwidth_bps=20e6,
                                 latency_s=0.05, bandwidth_sigma=0.75,
                                 latency_jitter_s=0.02),
}


def link_model(link: Union[str, LinkModel, None]) -> Optional[LinkModel]:
    """Resolve a preset name (or pass a LinkModel through; None -> None)."""
    if link is None or isinstance(link, LinkModel):
        return link
    try:
        return PRESETS[link]
    except KeyError:
        raise ValueError(f"unknown link preset {link!r}; "
                         f"known: {sorted(PRESETS)}") from None


def round_seconds(bits_per_silo: float, link: Union[str, LinkModel],
                  n: int = 1, seed: int = 0, reduce: str = "max") -> float:
    """Simulated seconds for ONE synchronous round of an ``n``-silo
    cohort each uplinking ``bits_per_silo`` bits.

    ``reduce="max"`` is the synchronous server (waits for the straggler
    — the FedNL deployment model); ``"mean"`` approximates a fully
    async/streaming server where per-silo uploads overlap."""
    model = link_model(link)
    t = model.silo_seconds(bits_per_silo, max(1, int(n)), seed=seed)
    if reduce == "max":
        return float(np.max(t))
    if reduce == "mean":
        return float(np.mean(t))
    raise ValueError(f"reduce must be 'max' or 'mean', got {reduce!r}")


def seconds_curve(bits_per_round: float, link: Union[str, LinkModel],
                  n: int, num_rounds: int, init_bits: float = 0.0,
                  seed: int = 0) -> np.ndarray:
    """(num_rounds+1,) cumulative simulated seconds — the time-domain
    twin of ``engine.records.bits_curve``. The link draw is fixed per
    cohort (silos keep their links across rounds), so the curve is the
    per-round time times the round index, plus a one-time cost for the
    init ship when ``init_bits`` is set."""
    per = round_seconds(bits_per_round, link, n, seed=seed)
    t0 = round_seconds(init_bits, link, n, seed=seed) if init_bits else 0.0
    return t0 + per * np.arange(num_rounds + 1)


def transfer_seconds(nbytes: int, link: Union[str, LinkModel],
                     n: int = 1, seed: int = 0) -> float:
    """Convenience: ``round_seconds`` for a payload given in bytes."""
    return round_seconds(8.0 * float(nbytes), link, n=n, seed=seed)
