"""Exact greedy acceptance.

The verify chunk feeds the model ``[current, d_1, ..., d_k]`` at positions
``L .. L + k``; row ``i`` of the returned logits is the model's next-token
distribution *after* consuming input token ``i``.  Greedy speculation is
exact: accept the longest draft prefix where ``d_{i+1} == argmax(logits_i)``,
then emit one bonus token from the first disagreeing (or final) position —
precisely the tokens plain greedy decode would have produced one tick at a
time, so outputs are byte-identical by construction.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np


def accept_greedy(draft: np.ndarray,
                  logits: np.ndarray) -> Tuple[int, List[int]]:
    """draft: [k] proposed tokens; logits: [>= k + 1, V] verify-chunk logits
    (only rows ``0 .. k`` are read).  Returns ``(n_accepted, emitted)`` where
    ``emitted`` is ``draft[:n_accepted]`` plus the bonus token — the exact
    greedy continuation, always at least one token."""
    k = len(draft)
    assert logits.shape[0] >= k + 1, "verify chunk shorter than draft + 1"
    return accept_greedy_ids(draft, np.argmax(logits[:k + 1], axis=-1))


def accept_greedy_ids(draft: np.ndarray,
                      arg: np.ndarray) -> Tuple[int, List[int]]:
    """``accept_greedy`` on the chunk's argmax ids ``arg`` ([>= k + 1]),
    so the engine moves token ids, not logits, from the device."""
    k = len(draft)
    assert len(arg) >= k + 1, "verify chunk shorter than draft + 1"
    n = 0
    while n < k and int(draft[n]) == int(arg[n]):
        n += 1
    return n, [int(t) for t in draft[:n]] + [int(arg[n])]
