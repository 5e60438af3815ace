"""Inference request lifecycle."""
from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional

import numpy as np


class State(enum.Enum):
    WAITING = "waiting"
    PREFILL = "prefill"
    DECODE = "decode"
    DONE = "done"
    FAILED = "failed"       # dropped (e.g. SLO-expired before admission)


# Per-request priority classes (tiered KV memory): rank 0 preempts LAST
# and its reservation debt is never lent out; rank 2 preempts FIRST and
# lends first under over-admission.  "standard" is the default everywhere,
# under which every priority-aware order degenerates to the pre-class
# behavior byte-for-byte.
PRIORITY_CLASSES = ("interactive", "standard", "batch")
PRIORITY_RANK = {c: i for i, c in enumerate(PRIORITY_CLASSES)}


def priority_rank(priority_class: str) -> int:
    """Victim/lending rank of a class (unknown classes rank as standard —
    a misspelled class must not silently become un-preemptable)."""
    return PRIORITY_RANK.get(priority_class, PRIORITY_RANK["standard"])


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # [L] int32
    adapter: str                       # adapter name ("" = base model)
    max_new_tokens: int = 64
    arrival: float = 0.0               # submit time (clock units)
    eos_token: int = -1                # -1 = never stop early
    aux_embed: Optional[np.ndarray] = None
    # NOTE: cross-request KV reuse needs no caller-side handle — the paged
    # cache content-addresses full blocks (chained hash of adapter + tokens),
    # so identical prompt heads share automatically (engine ``hash_dedup``)
    draft_suffix: Optional[np.ndarray] = None  # reference token stream
    # (prompt + expected output) for the static-suffix drafter (trace replay)
    priority_class: str = "standard"   # "interactive" | "standard" | "batch":
    # shapes the preemption victim order (batch evicted first, interactive
    # last) and over-admission lending (batch debt lent first, interactive
    # debt never lent); orthogonal to the scheduler's fairness ramp

    state: State = State.WAITING
    output: List[int] = dataclasses.field(default_factory=list)
    t_first_token: Optional[float] = None
    t_finish: Optional[float] = None
    token_times: List[float] = dataclasses.field(default_factory=list)
    dec_slot: int = -1                 # decode-table row while active
    prefilled: int = 0                 # prompt tokens whose K/V is already in
    # the cache (reused shared prefix + committed prefill chunks); the
    # request leaves PREFILL when this reaches prompt_len
    preemptions: int = 0               # recompute-preemption count: each one
    # rolled the emitted tokens into ``prompt`` and requeued the request;
    # ``arrival``/``t_first_token`` are never reset, so preemption surfaces
    # as decode latency in the SLO accounting, not as a fresh request
    rolled: int = 0                    # leading ``output`` tokens already
    # rolled into ``prompt`` by preemption: a second preemption must append
    # only ``output[rolled:]`` (or the prompt would duplicate tokens), and
    # the drafter context is ``prompt + output[rolled:]``
    recount_pending: bool = False      # preempted and not yet re-prefilled:
    # the next admission charges its recomputed suffix to
    # ``Metrics.preempted_tokens_recomputed``
    adapter_retained: bool = False     # this request holds a retain (and,
    # under unified paging, a pool pin) on its adapter.  Kept across
    # preemption — evicting the victim's adapter while it waits at the
    # head of the queue would just swap it straight back (thrash) — and
    # dropped at finish/failure
    swap_sid: Optional[int] = None     # host-pool swap-set id while the
    # request waits preempted with its KV blocks swapped out (tiered KV
    # memory).  Consumed (restored H2D or dropped) at re-admission; must be
    # dropped explicitly if the request fails before it is ever re-admitted

    @property
    def class_rank(self) -> int:
        return priority_rank(self.priority_class)

    @property
    def prompt_len(self) -> int:
        return int(len(self.prompt))

    @property
    def remaining_new(self) -> int:
        """Tokens the request may still emit.  Equals ``max_new_tokens``
        until a preemption rolls already-emitted tokens into the prompt —
        admission must project the remainder, not the original budget,
        or a resumed request could double-reserve its own output."""
        return max(self.max_new_tokens - len(self.output), 0)

    @property
    def done(self) -> bool:
        return self.state in (State.DONE, State.FAILED)

    def waiting_time(self) -> Optional[float]:
        if self.t_first_token is None:
            return None
        return self.t_first_token - self.arrival

    def decode_latencies(self) -> np.ndarray:
        if len(self.token_times) < 2:
            return np.zeros((0,))
        return np.diff(np.asarray(self.token_times))
