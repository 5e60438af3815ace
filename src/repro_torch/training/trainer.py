"""Interruptible multi-LoRA trainers sharing one computation flow.

Each ``MixedLoraTrainer`` owns one adapter slot, walks its dataset in
microbatch rows, and tracks its own gradient-accumulation window — several
trainers' rows ride in the same unified batch and share a single backward
pass, while the masked optimizer keeps their parameter updates isolated
(the functional ``MixedLoRAModelForTrainer``).

Trainers are interruptible by construction: the engine may give a trainer a
zero row-budget for any number of ticks (inference load spike), and training
resumes exactly where it stopped.

The port's own copy of ``repro.training.trainer`` (which holds no array
code), on the port's ``FTRow``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.flow import FTRow


@dataclasses.dataclass
class TrainerConfig:
    rows_per_micro: int = 2          # per_device_train_batch_size
    accum_steps: int = 4             # gradient_accumulation_steps
    epochs: int = 4
    eval_each_epoch: bool = True
    eval_rows_per_micro: int = 2


class MixedLoraTrainer:
    def __init__(self, name: str, slot: int,
                 train_data: Sequence[Tuple[np.ndarray, np.ndarray]],
                 eval_data: Sequence[Tuple[np.ndarray, np.ndarray]] = (),
                 tcfg: Optional[TrainerConfig] = None,
                 aux_embed: Optional[np.ndarray] = None):
        self.name, self.slot = name, slot
        self.train_data, self.eval_data = list(train_data), list(eval_data)
        self.cfg = tcfg or TrainerConfig()
        self.aux_embed = aux_embed
        self.epoch = 0
        self.cursor = 0
        self.phase = "train"          # train | eval
        self.eval_cursor = 0
        self.rows_since_update = 0
        self.train_losses: List[float] = []
        self.eval_losses: List[float] = []
        self.tokens_trained = 0
        self.tokens_evaled = 0
        self.optimizer_steps = 0

    # ------------------------------------------------------------------
    def pending(self) -> bool:
        return self.epoch < self.cfg.epochs

    @property
    def rows_per_apply(self) -> int:
        return self.cfg.rows_per_micro * self.cfg.accum_steps

    def next_rows(self, budget: int) -> List[FTRow]:
        """Up to ``budget`` rows of work (train or eval, per current phase)."""
        if not self.pending() or budget <= 0:
            return []
        rows: List[FTRow] = []
        if self.phase == "train":
            take = min(budget, self.cfg.rows_per_micro,
                       len(self.train_data) - self.cursor)
            for _ in range(take):
                toks, labels = self.train_data[self.cursor]
                rows.append(FTRow(tokens=toks, labels=labels, slot=self.slot,
                                  weight=1.0 / self.cfg.accum_steps,
                                  trainer=self.name, is_eval=False,
                                  aux_embed=self.aux_embed))
                self.cursor += 1
        else:
            take = min(budget, self.cfg.eval_rows_per_micro,
                       len(self.eval_data) - self.eval_cursor)
            for _ in range(take):
                toks, labels = self.eval_data[self.eval_cursor]
                rows.append(FTRow(tokens=toks, labels=labels, slot=self.slot,
                                  weight=0.0, trainer=self.name, is_eval=True,
                                  aux_embed=self.aux_embed))
                self.eval_cursor += 1
        return rows

    def record(self, rows: List[FTRow], losses: List[float],
               counts: List[float]) -> bool:
        """Account executed rows; returns True when this trainer's gradient
        accumulation window is full (engine should apply the optimizer)."""
        apply = False
        for r, l, c in zip(rows, losses, counts):
            if r.is_eval:
                self.eval_losses.append(l)
                self.tokens_evaled += int(c)
            else:
                self.train_losses.append(l)
                self.tokens_trained += int(c)
                self.rows_since_update += 1
        if self.rows_since_update >= self.rows_per_apply:
            self.rows_since_update = 0
            self.optimizer_steps += 1
            apply = True
        self._advance_phase()
        return apply

    def _advance_phase(self):
        if self.phase == "train" and self.cursor >= len(self.train_data):
            if self.cfg.eval_each_epoch and self.eval_data:
                self.phase = "eval"
                self.eval_cursor = 0
            else:
                self._next_epoch()
        elif self.phase == "eval" and self.eval_cursor >= len(self.eval_data):
            self._next_epoch()

    def _next_epoch(self):
        self.epoch += 1
        self.cursor = 0
        self.phase = "train"

    def force_apply_pending(self) -> bool:
        """Flush a partial accumulation window (end of training)."""
        if self.rows_since_update > 0:
            self.rows_since_update = 0
            self.optimizer_steps += 1
            return True
        return False
