"""SLO definitions and attainment accounting (paper Appendix C/D: max waiting
time 6 s, mean decode latency 200 ms, max decode latency 1000 ms)."""
from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np

from repro_torch.errors import AccountingInvariantError
from repro_torch.serving.request import Request, State


@dataclasses.dataclass(frozen=True)
class SLOConfig:
    max_waiting_s: float = 6.0
    mean_decode_ms: float = 200.0
    max_decode_ms: float = 1000.0


def spread_token_times(t_prev: float, now: float, n: int) -> list:
    """Per-token completion times for a multi-token (speculative verify)
    step: one step of latency ``now - t_prev`` produced ``n`` accepted
    tokens, so each is charged ``step_latency / n`` — NOT one inflated
    inter-step gap — keeping ``request_meets_slo`` meaningful under
    speculation."""
    if n < 1:
        raise AccountingInvariantError(
            f"spread_token_times needs n >= 1 accepted tokens, got {n}")
    dt = (now - t_prev) / n
    return [t_prev + (i + 1) * dt for i in range(n)]


def request_meets_slo(r: Request, slo: SLOConfig) -> bool:
    if r.state is not State.DONE:
        return False
    w = r.waiting_time()
    if w is None or w > slo.max_waiting_s:
        return False
    lats = r.decode_latencies()
    if lats.size:
        if lats.mean() * 1e3 > slo.mean_decode_ms:
            return False
        if lats.max() * 1e3 > slo.max_decode_ms:
            return False
    return True


def slo_attainment(requests: Iterable[Request], slo: SLOConfig) -> float:
    rs = list(requests)
    if not rs:
        return 1.0
    return sum(request_meets_slo(r, slo) for r in rs) / len(rs)


@dataclasses.dataclass
class Metrics:
    """Aggregate throughput metrics (paper Appendix C)."""
    decode_tokens: int = 0
    prefill_tokens: int = 0
    finetune_tokens: int = 0
    eval_tokens: int = 0
    steps: int = 0
    elapsed: float = 0.0
    busy_time: float = 0.0       # virtual-clock time spent executing steps
    # speculative decoding accounting
    spec_drafted: int = 0        # draft tokens submitted for verification
    spec_accepted: int = 0       # drafts that matched the greedy argmax
    spec_steps: int = 0          # verify steps with at least one draft
    # prefix caching / chunked prefill accounting.  ``prefill_tokens``
    # counts COMPUTED suffix tokens only (what the clock charges);
    # ``reused_prefix_tokens`` is the skipped shared-prefix span, so
    # prompt tokens served = prefill_tokens + reused_prefix_tokens.
    reused_prefix_tokens: int = 0
    max_pf_tokens_step: int = 0  # per-step prefill-token high-water mark
    starved_ticks: int = 0       # steps that ran prefill while decoders
    #                              were active but got no decode rows
    # content-hash dedup / prefix-aware admission accounting
    hash_hits: int = 0           # full blocks adopted from the hash index
    #                              (each one skipped a block of recompute
    #                              AND a block of storage)
    hash_blocks_resident: int = 0  # gauge: index population at last step
    probe_admissions: int = 0    # admissions reordered ahead of an older
    #                              waiter because their prefix was resident
    #                              (bounded by the scheduler fairness ramp)
    # fleet remote fetch accounting (multi-engine serving: blocks whose
    # K/V was copied in from a sibling replica's pool instead of being
    # recomputed locally — charged at CostModel.remote_per_block)
    remote_fetch_blocks: int = 0
    remote_fetch_time: float = 0.0
    # adapter residency accounting (unified adapter paging / LRU bank).
    # ``adapter_swap_ins`` counts host->device adapter payload transfers
    # during serving (charged at CostModel.adapter_swap_fixed + per byte);
    # ``adapter_resident_hits`` counts acquires served with no host
    # traffic (bank hit or pool-resident gather).
    adapter_swap_ins: int = 0
    adapter_swap_in_bytes: int = 0
    adapter_resident_hits: int = 0
    adapter_blocks_resident: int = 0   # gauge: pool blocks holding adapter
    #                              payloads at last step (unified paging)
    adapter_peak_coresident: int = 0   # max adapters simultaneously in HBM
    # over-admission / preemption accounting.  Preempted requests keep
    # their arrival and t_first_token, so the SLO cost of a preemption is
    # visible as decode latency; these count the mechanism itself.
    preemptions: int = 0         # recompute preemptions (victim requeued)
    preempted_tokens_recomputed: int = 0  # context tokens re-prefilled
    #                              after preemption (net of surviving
    #                              registry-resident prefix blocks)
    lent_blocks_peak: int = 0    # peak reservation debt not backed by the
    #                              free list (capacity actually lent out)
    # tiered KV memory (host block pool).  Swap-outs move a preemption
    # victim's blocks D2H instead of discarding them; restores bring them
    # back H2D at re-admission; demotions/rehydrations are the same tiering
    # applied to shed hash-index blocks.  Transfer bytes are charged to the
    # virtual clock at CostModel.d2h_per_byte / h2d_per_byte.
    kv_swap_outs: int = 0        # preemption victims swapped to host
    kv_swap_out_bytes: int = 0
    kv_swap_skips: int = 0       # preemptions where the decision rule (or
    #                              a full host pool) chose recompute
    kv_restores: int = 0         # swap sets restored H2D at re-admission
    kv_restore_bytes: int = 0
    kv_restored_tokens: int = 0  # prompt tokens served from restored K/V
    #                              beyond what index adoption already covered
    kv_demotions: int = 0        # shed index blocks captured to the host tier
    kv_rehydrated_blocks: int = 0  # demoted blocks re-published on demand
    host_bytes_used: int = 0     # gauge: host pool bytes at last step
    host_bytes_peak: int = 0     # high-water mark of host pool residency

    @property
    def acceptance_rate(self) -> float:
        return self.spec_accepted / max(self.spec_drafted, 1)

    def rates(self):
        e = max(self.elapsed, 1e-9)
        return {
            "DTPS": self.decode_tokens / e,
            "PTPS": self.prefill_tokens / e,
            "FTPS": self.finetune_tokens / e,
            "ETPS": self.eval_tokens / e,
            "steps_per_s": self.steps / e,
        }
