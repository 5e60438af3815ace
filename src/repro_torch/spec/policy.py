"""Speculation policy: static configuration + per-request adaptive depth.

Drafting is free but *verification* is not: every drafted token adds a query
row to the verify chunk, and every rejected token is wasted compute plus a
cache rollback.  ``AdaptiveK`` tracks a per-request acceptance EWMA and
walks the draft depth ``k`` between ``k_min`` and ``k_max`` so requests
whose history predicts well (templated text, greedy loops) speculate deeply
while adversarial ones fall back toward plain decode.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    enabled: bool = True
    k_max: int = 4                 # draft depth ceiling (chunk is 1 + k_max)
    k_min: int = 1                 # adaptive floor; k_max disables adaptation
    drafter: str = "ngram"         # "ngram" | "suffix" (trace replay)
    ngram_n: int = 3               # longest n-gram the lookup tries
    adaptive: bool = True
    ewma: float = 0.5              # smoothing of the acceptance-rate estimate
    raise_at: float = 0.8          # EWMA above which k steps up
    lower_at: float = 0.4          # EWMA below which k steps down


class AdaptiveK:
    """Per-request draft-depth controller (multiplicative-ish AIMD on k)."""

    def __init__(self, cfg: SpecConfig):
        self.cfg = cfg
        self.k = cfg.k_max if not cfg.adaptive else max(cfg.k_min,
                                                        (cfg.k_max + 1) // 2)
        self.rate = 1.0            # optimistic start: try speculating
        self.drafted = 0
        self.accepted = 0

    def update(self, n_drafted: int, n_accepted: int):
        """Feed one verify step's outcome.  Steps where nothing was drafted
        (no n-gram match) carry no signal and leave the controller alone."""
        if n_drafted <= 0:
            return
        self.drafted += n_drafted
        self.accepted += n_accepted
        c = self.cfg
        step_rate = n_accepted / n_drafted
        self.rate = c.ewma * step_rate + (1.0 - c.ewma) * self.rate
        if not c.adaptive:
            return
        if self.rate >= c.raise_at:
            self.k = min(self.k + 1, c.k_max)
        elif self.rate < c.lower_at:
            self.k = max(self.k - 1, c.k_min)
