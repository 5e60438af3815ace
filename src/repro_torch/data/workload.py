"""Serving workload generators: Poisson arrivals, the paper's mutable-load
schedule (Table 7), and BurstGPT-like bursty traces (Table 8 statistics)."""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np


def poisson_arrivals(rps: float, n: int, seed: int = 0,
                     t0: float = 0.0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / max(rps, 1e-9), size=n)
    return t0 + np.cumsum(gaps)


@dataclasses.dataclass(frozen=True)
class Phase:
    rps: float
    start: float
    duration: float
    n: int
    adapter_index: int = 0


# Table 7 — mutable capacity allocation simulation
MUTABLE_PHASES: Tuple[Phase, ...] = (
    Phase(rps=1.0, start=0.0, duration=120.0, n=120, adapter_index=0),
    Phase(rps=2.5, start=120.0, duration=60.0, n=150, adapter_index=1),
    Phase(rps=2.0, start=180.0, duration=120.0, n=240, adapter_index=2),
    Phase(rps=1.0, start=300.0, duration=120.0, n=120, adapter_index=3),
)


def phased_arrivals(phases: Sequence[Phase], seed: int = 0
                    ) -> List[Tuple[float, int]]:
    """[(arrival_time, adapter_index)] sorted by time."""
    rng = np.random.default_rng(seed)
    out = []
    for ph in phases:
        gaps = rng.exponential(1.0 / ph.rps, size=ph.n)
        t = ph.start + np.cumsum(gaps)
        t = t[t <= ph.start + ph.duration * 1.5]
        out.extend((float(x), ph.adapter_index) for x in t)
    out.sort()
    return out


# Table 8 — BurstGPT time-period statistics (mean RPS, peak RPS, requests)
BURSTGPT_PERIODS = {
    "d29_13h": dict(requests=676, mean_rps=0.563, peak_rps=1.5),
    "d29_15h": dict(requests=2145, mean_rps=1.788, peak_rps=11.5),
    "d29_16h": dict(requests=1465, mean_rps=1.226, peak_rps=7.0),
    "d33_1340": dict(requests=2823, mean_rps=2.354, peak_rps=10.0),
    "d33_1140": dict(requests=2360, mean_rps=1.966, peak_rps=12.0),
    "d33_11h": dict(requests=1856, mean_rps=1.547, peak_rps=10.5),
}


def burstgpt_like(period: str, duration: float = 1200.0, seed: int = 0,
                  scale: float = 1.0) -> np.ndarray:
    """Bursty arrival times reproducing a BurstGPT slice's mean/peak RPS:
    a baseline Poisson process plus short spikes reaching the peak rate.
    ``scale`` shrinks the trace (fewer requests, same shape) for CPU runs."""
    st = BURSTGPT_PERIODS[period]
    rng = np.random.default_rng(seed)
    n = int(st["requests"] * scale)
    mean, peak = st["mean_rps"] * scale, st["peak_rps"] * scale
    # 85% of volume as baseline Poisson, 15% inside spikes
    n_spike = int(0.15 * n)
    base = poisson_arrivals(max(mean * 0.85, 1e-6), n - n_spike, seed)
    base = base[base < duration]
    spikes = []
    n_windows = max(1, n_spike // max(int(peak * 2), 1))
    for w in range(n_windows):
        t0 = rng.uniform(0, duration - 2.0)
        k = min(n_spike - len(spikes), max(int(peak * 2), 1))
        spikes.extend(t0 + np.sort(rng.uniform(0, 2.0, size=k)))
        if len(spikes) >= n_spike:
            break
    t = np.sort(np.concatenate([base, np.asarray(spikes)]))
    return t
