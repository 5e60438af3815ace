"""Model-free draft-token proposers.

Both drafters run on the host between engine ticks and cost no accelerator
time — the bet of prompt-lookup speculation is that real text (and greedy
decode loops) repeat themselves, so the request's OWN token history is a
usable draft model.  A drafter may return fewer than ``k`` tokens (or none:
that row degenerates to plain one-token decode for the tick).
"""
from __future__ import annotations

import abc
from typing import Optional

import numpy as np


class Drafter(abc.ABC):
    """Proposes up to ``k`` continuation tokens for a token history."""

    @abc.abstractmethod
    def draft(self, context: np.ndarray, k: int) -> np.ndarray:
        """context: [L] int tokens (prompt + generated so far); returns
        [<=k] int draft tokens (possibly empty)."""


class NgramDrafter(Drafter):
    """Prompt-lookup decoding: find the most recent earlier occurrence of
    the history's trailing n-gram and propose the tokens that followed it.
    Tries the longest n first (more specific match, better acceptance) and
    backs off to shorter n-grams down to ``min_n``."""

    def __init__(self, max_n: int = 3, min_n: int = 1):
        assert max_n >= min_n >= 1
        self.max_n, self.min_n = max_n, min_n

    def draft(self, context: np.ndarray, k: int) -> np.ndarray:
        ctx = np.asarray(context)
        L = len(ctx)
        if k <= 0 or L < self.min_n + 1:
            return ctx[:0]
        for n in range(min(self.max_n, L - 1), self.min_n - 1, -1):
            tail = ctx[L - n:]
            # windows ending strictly before the end, newest match first
            for start in range(L - n - 1, -1, -1):
                if np.array_equal(ctx[start:start + n], tail):
                    cont = ctx[start + n:start + n + k]
                    if len(cont):
                        return cont.copy()
        return ctx[:0]


class StaticSuffixDrafter(Drafter):
    """Trace-replay drafter: drafts come from a known reference sequence
    (prompt + expected output), indexed by how many tokens the request has
    produced so far.  Acceptance is 1.0 when the trace matches the model's
    greedy path — the upper-bound harness for benchmarks and the exactness
    tests — and 0 when it diverges (the adversarial case)."""

    def __init__(self, sequence: np.ndarray):
        self.sequence = np.asarray(sequence)

    def draft(self, context: np.ndarray, k: int) -> np.ndarray:
        at = len(context)
        return self.sequence[at:at + k].copy()


def make_drafter(kind: str, *, ngram_n: int = 3,
                 suffix: Optional[np.ndarray] = None) -> Drafter:
    if kind == "ngram":
        return NgramDrafter(max_n=ngram_n)
    if kind == "suffix":
        if suffix is None:
            raise ValueError("suffix drafter needs a reference sequence "
                             "(Request.draft_suffix)")
        return StaticSuffixDrafter(suffix)
    raise ValueError(f"unknown drafter kind: {kind!r}")
