"""Synthetic stand-ins for the paper's datasets (no downloads).

Sequences carry learnable structure (orderly markov-style token streams with
per-dataset transition signatures) so fine-tuning loss genuinely decreases
and different adapters genuinely learn different things — enough to exercise
every system path the paper benchmarks with Alpaca / GSM8K / ShareGPT.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np


def _markov_rows(n_rows: int, len_lo: int, len_hi: int, vocab: int,
                 seed: int, stride: int) -> List[Tuple[np.ndarray, np.ndarray]]:
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n_rows):
        L = int(rng.integers(len_lo, len_hi + 1))
        start = int(rng.integers(0, vocab))
        noise = rng.integers(0, 3, size=L)
        toks = (start + stride * np.arange(L) + noise) % vocab
        toks = toks.astype(np.int32)
        rows.append((toks, toks.copy()))          # causal-LM labels = inputs
    return rows


def alpaca_like(n_rows: int = 64, vocab: int = 512, seed: int = 0,
                len_lo: int = 24, len_hi: int = 96):
    """Instruction-tuning-ish rows (dataset signature: stride 3)."""
    return _markov_rows(n_rows, len_lo, len_hi, vocab, seed, stride=3)


def gsm8k_like(n_rows: int = 64, vocab: int = 512, seed: int = 1,
               len_lo: int = 48, len_hi: int = 160):
    """Math-reasoning-ish rows (longer; dataset signature: stride 7)."""
    return _markov_rows(n_rows, len_lo, len_hi, vocab, seed, stride=7)


def sharegpt_prompts(n: int = 128, vocab: int = 512, seed: int = 2,
                     len_lo: int = 8, len_hi: int = 64) -> List[np.ndarray]:
    """Inference prompts with a ShareGPT-ish length spread."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        L = int(np.clip(rng.lognormal(np.log((len_lo + len_hi) / 2), 0.5),
                        len_lo, len_hi))
        out.append(rng.integers(0, vocab, size=L).astype(np.int32))
    return out


def split_eval(rows, frac: float = 0.125):
    k = max(1, int(len(rows) * frac))
    return rows[k:], rows[:k]
