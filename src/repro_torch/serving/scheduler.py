"""Continuous-batching scheduler with mutable capacity allocation.

Each tick the scheduler decides (a) how many waiting requests to admit into
the prefill bucket and (b) how many fine-tuning microbatch rows to co-run.
The fine-tuning budget shrinks as inference load rises (decode occupancy +
queue pressure) and recovers when load drops — the paper's Figure-5
behaviour ("the fine-tuning task makes concessions for the inference task").

Admission is a *memory* budget, not a slot count: under the paged KV layout
a request is admitted only if its projected block need (prompt + max new
tokens, in ``block_size`` units) fits the free pool, so short requests keep
flowing when long ones would have pinned whole dense rows.  The dense layout
degenerates to the old slot check (``free_blocks=None``).

Prefix-aware admission (``probe_fn``): with the content-hash dedup index
live, a request whose prompt head is already resident costs a fraction of a
cold request — its prefill skips the resident span and its block charge
drops by the adopted blocks.  The scheduler therefore scores waiting
requests by resident-prefix fraction and admits high-residency requests
first (the RadixAttention/SGLang insight: cache-aware scheduling compounds
the cache's win).  A fairness ramp bounds the reordering: a request's score
also rises with its queue wait and saturates at 1.0 — strictly above any
possible residency fraction — after ``prefix_ramp_s``, so a zero-residency
request can be passed over for at most the ramp window before it outranks
every fresh high-residency arrival (FIFO among ramped requests).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

from repro_torch.serving.kvcache import projected_blocks as _projected_blocks
from repro_torch.serving.request import Request


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    max_prefill_per_tick: int = 4
    max_prefill_tokens: int = 4096     # token budget per prefill bucket
    ft_rows_max: int = 4               # fine-tuning rows when idle
    ft_token_budget: int = 2048        # cap ft tokens per tick
    concede_at_queue: int = 1          # waiting reqs at which ft fully yields
    lent_full_yield: float = 0.25      # lent-debt fraction at which ft fully
    #                                    yields: over-admitted lending is a
    #                                    preemption precursor, so fine-tuning
    #                                    concedes BEFORE inference requests
    #                                    start getting preempted
    prefix_ramp_s: float = 1.0         # fairness ramp for prefix-aware
    #                                    admission: queue wait at which a
    #                                    cold (zero-residency) request's
    #                                    score saturates and it outranks any
    #                                    fresh high-residency arrival
    adapter_affinity: float = 0.35     # admission bonus for a request whose
    #                                    adapter needs no swap-in — already
    #                                    resident, OR being swapped in by an
    #                                    earlier admit THIS tick (same-
    #                                    adapter co-scheduling amortizes one
    #                                    H2D transfer).  Capped strictly
    #                                    below 1.0, so the fairness ramp's
    #                                    saturated wait still dominates


@dataclasses.dataclass
class Decision:
    admit: List[Request]
    ft_rows: int
    load: float
    probe_admissions: int = 0      # admits reordered ahead of an older
    #                                waiter by prefix residency this tick


def projected_blocks(r: Request, block_size: int, s_max: int,
                     headroom: int = 0) -> int:
    """Blocks the request reserves for its whole projected life (the
    manager's formula, on a Request); ``headroom`` adds transient
    speculative-draft tokens."""
    return _projected_blocks(r.prompt_len, r.max_new_tokens + headroom,
                             block_size, s_max)


class Scheduler:
    def __init__(self, cfg: SchedulerConfig, capacity: int):
        self.cfg, self.capacity = cfg, capacity

    def decide(self, waiting: List[Request], n_active: int,
               n_free_slots: int, pf_capacity: int,
               trainers_pending: bool, *,
               free_blocks: Optional[int] = None, total_blocks: int = 0,
               block_size: int = 0, s_max: int = 0,
               need_fn: Optional[Callable[[Request], int]] = None,
               spec_headroom: int = 0, pf_rows_used: int = 0,
               pf_token_budget: Optional[int] = None,
               suffix_fn: Optional[Callable[[Request], int]] = None,
               chunked: bool = False,
               lent_frac: float = 0.0,
               probe_fn: Optional[Callable[[Request], int]] = None,
               adapter_fn: Optional[Callable[[Request], bool]] = None,
               now: float = 0.0) -> Decision:
        """``need_fn`` (paged engines) returns the blocks a request would
        actually consume — projected blocks minus index-resident adopted
        blocks — so the gate mirrors what admission will really reserve.
        ``spec_headroom`` widens the fallback projection by the transient
        speculative-draft tokens a resident request may hold mid-verify.

        Prefix-aware accounting: ``suffix_fn`` returns the tokens prefill
        will actually *compute* for a request (prompt minus the resident
        shared-prefix span) — the token budget charges that, not the raw
        prompt length.  ``pf_rows_used``/``pf_token_budget`` subtract the
        bucket rows and tokens already claimed by in-flight partial-prefill
        chunks.  With ``chunked`` set, a long suffix no longer monopolizes
        a tick: admission charges only the first chunk (``min(suffix,
        remaining budget)``) and stops when the per-tick budget is spent —
        the engine feeds the rest as later chunks.

        Prefix-aware admission ORDER: ``probe_fn`` returns the resident
        prompt tokens the dedup index would serve; waiting requests are
        visited by ``max(residency fraction, wait / prefix_ramp_s)`` (see
        module docstring — the wait term saturates at 1.0, strictly above
        any residency fraction, so no request starves past the ramp).

        ``lent_frac`` is the fraction of outstanding reservation debt the
        over-admission gate has actually lent out (0 under the conservative
        gate).  Lending is the precursor of preemption, so it feeds the
        fine-tuning concession directly: ft rows ramp to zero by
        ``lent_full_yield`` — the trainer yields capacity *before* any
        inference request has to be preempted.

        Adapter-residency-aware admission (``adapter_fn``, unified adapter
        paging): ``adapter_fn(r)`` says whether the request's adapter needs
        no swap-in.  Warm requests earn ``adapter_affinity`` on top of
        their residency fraction (capped strictly below the ramp's
        saturation, so the starvation bound is untouched), and selection
        turns GREEDY: each pick re-scores the queue with the adapters of
        already-picked requests counted warm — so same-adapter waiters
        cluster into one tick and amortize a single swap-in, the LoRAFusion
        batching insight."""
        c = self.cfg
        admit: List[Request] = []
        remaining = list(waiting)
        ramp = max(c.prefix_ramp_s, 1e-9)
        pending_adapters: set = set()

        def score(r: Request) -> float:
            # residency fraction is < 1 by construction (at least one
            # prompt token is never cached), so a ramp-saturated wait
            # strictly dominates any fresh high-residency arrival
            resid = (probe_fn(r) / max(r.prompt_len, 1)
                     if probe_fn is not None else 0.0)
            if adapter_fn is not None and (
                    not r.adapter or adapter_fn(r)
                    or r.adapter in pending_adapters):
                resid = min(resid + c.adapter_affinity, 1.0 - 1e-9)
            return max(resid, min((now - r.arrival) / ramp, 1.0))

        reorder = (probe_fn is not None or adapter_fn is not None) \
            and len(waiting) > 1
        if reorder and adapter_fn is None:
            # static scores: one sort up front (the pre-paging behavior,
            # byte-identical ordering).  Priority class breaks score ties
            # only (interactive ahead of standard ahead of batch) — with
            # all-standard traffic the rank is a constant and the order is
            # exactly the pre-class one
            remaining.sort(key=lambda r: (-score(r), r.class_rank,
                                          r.arrival, r.rid))
        budget = (c.max_prefill_tokens if pf_token_budget is None
                  else pf_token_budget)
        row_cap = max(min(c.max_prefill_per_tick, n_free_slots,
                          pf_capacity) - pf_rows_used, 0)
        blocks_left = free_blocks
        while remaining:
            if len(admit) >= row_cap:
                break
            if reorder and adapter_fn is not None:
                # greedy: every pick can warm its adapter for the rest of
                # the queue, so scores are recomputed per pick (the queue
                # is tick-bounded; this is O(n^2 log n) over a small n)
                remaining.sort(key=lambda r: (-score(r), r.class_rank,
                                              r.arrival, r.rid))
            r = remaining[0]
            tok = suffix_fn(r) if suffix_fn is not None else r.prompt_len
            if chunked:
                if budget <= 0:
                    break
                tok = min(tok, budget)
            elif tok > budget and admit:
                break
            if blocks_left is not None:
                need = (need_fn(r) if need_fn is not None
                        else projected_blocks(r, block_size, s_max,
                                              headroom=spec_headroom))
                if need > blocks_left:
                    break              # memory-bound: stop admitting this tick
                blocks_left -= need
            admit.append(r)
            remaining.pop(0)
            if r.adapter:
                pending_adapters.add(r.adapter)
            # an over-budget FIRST request still runs (unchunked prefill
            # cannot split it), but its charge is clamped to the budget it
            # actually had — a negative balance would wrongly veto requests
            # whose suffix is fully cached (0 computed tokens) and disagree
            # with the chunked boundary, which never over-charges
            budget = max(budget - tok, 0)

        probe_admissions = 0
        if reorder and admit:
            admitted = set(id(r) for r in admit)
            passed = [w for w in waiting if id(w) not in admitted]
            probe_admissions = sum(
                1 for r in admit
                if any((w.arrival, w.rid) < (r.arrival, r.rid)
                       for w in passed))

        occupancy = n_active / max(self.capacity, 1)
        if free_blocks is not None and total_blocks > 0:
            # free_blocks goes negative while over-admitted lending is
            # claimed; occupancy saturates at 1 rather than overshooting
            occupancy = max(occupancy,
                            min(1.0, 1.0 - (free_blocks / total_blocks)))
        queue_pressure = min(1.0, (len(waiting) - len(admit))
                             / max(c.concede_at_queue, 1))
        lent_load = min(1.0, lent_frac / max(c.lent_full_yield, 1e-9))
        load = max(occupancy, queue_pressure, lent_load)
        if not trainers_pending:
            ft_rows = 0
        else:
            ft_rows = max(int(round(c.ft_rows_max * (1.0 - load))), 0)
            if len(waiting) - len(admit) >= c.concede_at_queue:
                ft_rows = 0
        return Decision(admit=admit, ft_rows=ft_rows, load=load,
                        probe_admissions=probe_admissions)
