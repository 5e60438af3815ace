"""UnifiedEngine — the Loquetier runtime on the serve path.

Every tick assembles ONE unified batch (prefill + decode or verify),
executes ONE forward step, then scatters sampled tokens back to the
requests.  Port of ``repro.serving.engine`` with its default settings: paged
KV, ``block_size=32``, content-hash dedup on, suffix-only prefill over
adopted prefixes, and speculative decoding under ``EngineConfig.spec``
(model-free drafters, ``(1 + k)``-token verify chunks, exact greedy
acceptance, rollback through ``PagedCacheManager.truncate``).  With
``EngineConfig(paged=False)`` (or a sliding-window model) it serves on dense
rows (``CacheManager``) as the JAX engine does: a slot per request, every
prompt prefilled whole, no table growth, no dedup, no suffix or chunked
prefill and no speculation.  Tensors live on the model's device; the model
writes the cache in place, so ``cachemgr.update`` swaps nothing.

Fine-tuning rows and trainers (``add_trainer``), the host KV tier
(``kv_host_blocks``), unified adapter paging (``adapter_paging``) and
over-admission lending belong to later slices and raise
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import flow
from repro_torch.core.unified import make_forward_step
from repro_torch.core.virtualization import MixedLoraModel
from repro_torch.serving.clock import CostModel, VirtualClock, WallClock
from repro_torch.serving.kvcache import (CacheManager, OutOfBlocksError,
                                         PagedCacheManager,
                                         request_chain_keys)
from repro_torch.serving.request import Request, State
from repro_torch.serving.scheduler import Scheduler, SchedulerConfig
from repro_torch.serving.slo import Metrics, SLOConfig, spread_token_times
from repro_torch.spec import AdaptiveK, Drafter, accept_greedy_ids, \
    make_drafter

TRAINING_SLICE = "the training slice (ft rows, grad step, AdamW, trainer)"
FEATURES_SLICE = "a later engine-features slice"


@dataclasses.dataclass
class EngineConfig:
    capacity: int = 8                 # max concurrent decode requests
    pf_capacity: int = 4              # prefill rows per tick
    s_max: int = 256                  # cache sequence capacity
    scheduler: SchedulerConfig = dataclasses.field(default_factory=SchedulerConfig)
    slo: SLOConfig = dataclasses.field(default_factory=SLOConfig)
    flow: flow.FlowConfig = dataclasses.field(default_factory=flow.FlowConfig)
    attn_chunk: int = 0
    virtual_time: bool = False        # deterministic trace replay
    paged: bool = True                # block-table KV layout (False: dense
    #                                   rows; keep s_max a padded prompt
    #                                   bucket there, see UnifiedEngine)
    block_size: int = 32              # KV tokens per block
    n_blocks: int = 0                 # pool size; 0 = match dense capacity
    over_admit: float = 1.0           # reservation lending (later slice)
    spec: Optional[object] = None     # spec.SpecConfig (speculation)
    prefill_chunk: int = 0            # per-tick prefill-token budget
    hash_dedup: bool = True           # content-hash block dedup
    adapter_paging: bool = False      # unified adapter paging (later slice)
    cost: Optional[CostModel] = None  # virtual-clock cost model override
    kv_host_blocks: int = 0           # host KV tier (later slice)


class UnifiedEngine:
    def __init__(self, model: MixedLoraModel,
                 ecfg: Optional[EngineConfig] = None):
        self.model = model
        self.ecfg = ecfg or EngineConfig()
        self.cfg = model.cfg
        e = self.ecfg
        if e.adapter_paging:
            raise NotImplementedError(f"adapter_paging comes with "
                                      f"{FEATURES_SLICE}")
        self.device = model.store.device
        dtype = model.base["embed"].dtype
        if model.base["embed"].device.type != self.device.type:
            raise ValueError("base params and adapter bank live on "
                             "different devices")
        self.paged = e.paged and self.cfg.sliding_window == 0
        if self.paged:
            self.cachemgr = PagedCacheManager(
                self.cfg, e.capacity, e.pf_capacity, e.s_max,
                device=self.device, dtype=dtype, block_size=e.block_size,
                n_blocks=e.n_blocks, over_admit=e.over_admit,
                hash_dedup=e.hash_dedup, host_blocks=e.kv_host_blocks)
        else:
            self.cachemgr = CacheManager(self.cfg, e.capacity,
                                         e.pf_capacity, e.s_max,
                                         device=self.device, dtype=dtype)
            over = flow._pad_seq(e.s_max, e.flow)
            if over > e.s_max:
                # as in the JAX model, a prompt bucket longer than the row
                # is written rolling, so its padding overwrites the
                # prompt's first slots (ROADMAP Queue 3)
                warnings.warn(
                    f"dense rows of {e.s_max} slots: a prompt that pads to "
                    f"the {over}-token bucket has its first slots "
                    f"overwritten by the bucket's padding; choose an s_max "
                    f"that is a padded prompt bucket", RuntimeWarning,
                    stacklevel=2)
        st = model.store
        self._swaps_base = (st.swap_ins, st.swap_in_bytes, st.resident_hits)
        self._swaps_seen = self._swaps_base[:2]
        self.sched = Scheduler(e.scheduler, e.capacity)
        self.clock = VirtualClock(e.cost) if e.virtual_time else WallClock()
        self.metrics = Metrics()
        # paged rows prefill suffix-only: shared-prefix K/V is read through
        # the block tables instead of recomputed (attention-only decoder),
        # and long prompts may prefill in chunks; dense rows recompute every
        # prompt whole
        self.chunk_budget = (e.prefill_chunk
                             if e.prefill_chunk > 0 and self.paged else 0)
        self.prefilling: Dict[int, Request] = {}  # slot -> partial prefill
        self.hash_dedup = self.paged and e.hash_dedup
        self.forward_step = make_forward_step(self.cfg,
                                              block_t=e.flow.block_t,
                                              attn_chunk=e.attn_chunk)
        self.future: List[Request] = []       # arrival-sorted
        self.waiting: List[Request] = []
        self.active: Dict[int, Request] = {}  # decode slot -> request
        self.finished: List[Request] = []
        self._last_tokens = np.zeros((e.capacity,), np.int64)
        # speculative decoding: rollback-able K/V (paged blocks) and a
        # positional cache, which the attention-only decoder has
        self.spec = e.spec if (e.spec is not None and e.spec.enabled
                               and self.paged) else None
        self._spec: Dict[int, Tuple[Drafter, AdaptiveK]] = {}

    @property
    def spec_headroom(self) -> int:
        """Transient +k draft tokens each resident request may hold
        mid-verify, charged to its block budget at admission."""
        return self.spec.k_max if self.spec else 0

    def _headroom_for(self, r: Request) -> int:
        """Per-request draft headroom: when the +k charge would push the
        request past the whole pool (it fits its plain projection but not
        the inflated one), admit it with no reserved draft room instead of
        stranding it; its drafts then ride the best-effort overshoot path
        in ``grow`` and are trimmed when the pool is dry."""
        h = self.spec_headroom
        if h and self.cachemgr.projected_blocks(
                r.prompt_len, r.remaining_new + h) \
                > self.cachemgr.total_blocks:
            return 0
        return h

    # ------------------------------------------------------------------
    def submit(self, req: Request):
        if req.arrival > self.clock.now():
            self.future.append(req)
            self.future.sort(key=lambda r: r.arrival)
        else:
            self.waiting.append(req)

    def add_trainer(self, tr):
        raise NotImplementedError(f"trainers come with {TRAINING_SLICE}")

    def _keys_of(self, r: Request) -> Optional[List[str]]:
        if not self.hash_dedup or r.aux_embed is not None:
            return None
        return request_chain_keys(r, self.cachemgr.block_size)

    def _resident_tokens(self, r: Request) -> int:
        keys = self._keys_of(r)
        if keys is None:
            return 0
        return self.cachemgr.probe(r.prompt, r.adapter, keys=keys)

    def _pull_arrivals(self):
        now = self.clock.now()
        while self.future and self.future[0].arrival <= now:
            self.waiting.append(self.future.pop(0))

    # ------------------------------------------------------------------
    def tick(self) -> bool:
        """One scheduling + execution round; returns False when idle."""
        self._pull_arrivals()
        e = self.ecfg
        cm = self.cachemgr
        # prefill rows: continuing partial-prefill chunks first, then fresh
        # admissions; ``chunks`` parallels ``pf_reqs``
        pf_reqs: List[flow.PFReq] = []
        chunks: List[Tuple[Request, int, bool]] = []
        budget_left = self.chunk_budget if self.chunk_budget else None
        if self.paged:
            for slot, r in list(self.prefilling.items()):
                if len(pf_reqs) >= e.pf_capacity:
                    break
                if budget_left is not None and budget_left <= 0:
                    break
                rem = r.prompt_len - r.prefilled
                take = rem if budget_left is None else min(rem, budget_left)
                if budget_left is not None:
                    budget_left -= take
                pf_reqs.append(flow.PFReq(
                    tokens=r.prompt[r.prefilled:r.prefilled + take],
                    rid=r.rid,
                    slot=(self.model.store.slot_of(r.adapter)
                          if r.adapter else -1),
                    block_table=cm.table_of(slot), cached_len=r.prefilled))
                chunks.append((r, take, r.prefilled + take >= r.prompt_len))
            # a request is unservable only when its FRESH block need can
            # never fit the pool
            for r in list(self.waiting):
                if cm.projected_blocks(r.prompt_len, r.remaining_new) \
                        <= cm.total_blocks:
                    continue
                need = cm.fresh_need(r.prompt_len, r.remaining_new,
                                     r.prompt, r.adapter,
                                     keys=self._keys_of(r),
                                     shareable=r.aux_embed is None)
                if need > cm.total_blocks:
                    r.state = State.FAILED
                    r.t_finish = self.clock.now()
                    self._drop_retain(r)
                    self.waiting.remove(r)
                    self.finished.append(r)
            decision = self.sched.decide(
                self.waiting, len(self.active) + len(self.prefilling),
                cm.n_free, e.pf_capacity, False,
                free_blocks=cm.free_blocks + cm.reclaimable_blocks,
                total_blocks=cm.total_blocks, block_size=cm.block_size,
                s_max=e.s_max,
                need_fn=lambda r: cm.fresh_need(
                    r.prompt_len, r.remaining_new, r.prompt, r.adapter,
                    headroom=self._headroom_for(r), keys=self._keys_of(r),
                    shareable=r.aux_embed is None),
                spec_headroom=self.spec_headroom,
                pf_rows_used=len(pf_reqs), pf_token_budget=budget_left,
                suffix_fn=lambda r: r.prompt_len - self._resident_tokens(r),
                chunked=bool(self.chunk_budget),
                lent_frac=0.0,      # no lending: over_admit is 1.0
                probe_fn=self._resident_tokens if self.hash_dedup else None,
                now=self.clock.now())
        else:
            # dense rows: a free slot is the whole admission gate
            decision = self.sched.decide(self.waiting, len(self.active),
                                         cm.n_free, e.pf_capacity, False)

        # prefill admissions: adapters resolved once per tick per name and
        # held until the admission loop ends
        resolved: Dict[str, int] = {}
        unknown: set = set()
        deferred: set = set()

        # reprolint: ownership-transfer — holds land in ``resolved``; the
        # finally around _admit_loop releases every one exactly once
        def _resolve(name: str):
            if name in resolved or name in unknown or name in deferred:
                return
            try:
                resolved[name] = self.model.store.acquire(name)
                self.model.store.retain(name)
            except KeyError:
                unknown.add(name)
            except RuntimeError:
                deferred.add(name)     # bank saturated this tick

        try:
            self._admit_loop(decision, pf_reqs, chunks, budget_left,
                             resolved, unknown, _resolve)
        finally:
            for name in resolved:
                self.model.store.release(name)

        # decode / verify bucket: the full capacity table whenever a
        # request is active; chunk width 1 + k_max whenever speculation is
        # on, so the bucket shape is fixed
        use_dec = bool(self.active)
        Sd = 1 + (self.spec.k_max if (self.spec and use_dec) else 0)
        drafts: Dict[int, np.ndarray] = {}
        dec_lens = None
        plans: List[Tuple[int, Request, int, np.ndarray]] = []
        if use_dec:
            # phase 1: drafts and block growth, preempting when a fork
            # finds the pool dry.  Slots carrying a prefill row this tick
            # are pinned: their PFReq already holds a block table.
            pinned = frozenset(c[0].dec_slot for c in chunks)
            for slot, r in list(self.active.items()):
                if slot not in self.active:
                    continue              # preempted as an earlier victim
                L = int(cm.lens[slot])
                draft = np.zeros((0,), np.int64)
                if Sd > 1:
                    drafter, ctl = self._spec[slot]
                    # clamp drafts to what the request can still emit and
                    # to the context limit (writes land at L .. L + k)
                    k = min(ctl.k, r.max_new_tokens - len(r.output) - 1,
                            e.s_max - 1 - L)
                    if k > 0:
                        # the prompt already holds output[:rolled] after a
                        # preemption: append only the unrolled tail
                        draft = np.asarray(drafter.draft(
                            np.concatenate([np.asarray(r.prompt, np.int64),
                                            np.asarray(r.output[r.rolled:],
                                                       np.int64)]),
                            k), np.int64)
                if self.paged:
                    # grow the table over the chunk and copy-on-write shared
                    # blocks in the write range; a dry pool trims the draft
                    # tail
                    writable = self._grow_or_preempt(slot, r, L,
                                                     1 + len(draft), pinned)
                    if slot not in self.active:
                        continue          # became its own victim
                    draft = draft[:max(writable - 1, 0)]
                plans.append((slot, r, L, draft))
            plans = [p for p in plans if p[0] in self.active]
            use_dec = bool(plans)
        planned = frozenset(p[0] for p in plans)
        if use_dec:
            # phase 2: assemble the bucket from the surviving rows
            dec_tokens = (np.zeros((e.capacity, Sd), np.int64) if Sd > 1
                          else np.zeros((e.capacity,), np.int64))
            dec_pos = np.zeros((e.capacity,), np.int64)
            dec_slots = np.full((e.capacity,), -1, np.int64)
            if Sd > 1:
                dec_lens = np.zeros((e.capacity,), np.int64)
            for slot, r, L, draft in plans:
                if Sd > 1:
                    dec_tokens[slot, 0] = self._last_tokens[slot]
                    dec_tokens[slot, 1:1 + len(draft)] = draft
                    dec_lens[slot] = 1 + len(draft)
                    drafts[slot] = draft
                else:
                    dec_tokens[slot] = self._last_tokens[slot]
                dec_pos[slot] = L
                dec_slots[slot] = (self.model.store.slot_of(r.adapter)
                                   if r.adapter else -1)
            dec_tables = cm.dec_tables(self.active) if self.paged else None
        else:
            dec_tokens = dec_pos = dec_slots = np.zeros((0,), np.int64)
            dec_tables = None

        if not pf_reqs and not use_dec:
            if self.future:
                self.clock.advance_to(self.future[0].arrival)
                return True
            return False

        batch = flow.assemble(pf_reqs, dec_tokens, dec_pos, dec_slots,
                              e.flow, self.device, dec_tables=dec_tables,
                              dec_lens=dec_lens)
        if pf_reqs and self.active and batch.dec is None:
            self.metrics.starved_ticks += 1
        store = self.model.store
        out = self.forward_step(self.model.base, store.bank, store.scale,
                                batch, cm.step_cache())
        # the one step barrier: greedy tokens drive the next tick's inputs
        # (argmax on the device, only token ids cross to the host; [Bd, Sd]
        # of them for verify chunks)
        pf_tok_ids = (out.pf_logits.argmax(-1).cpu().numpy()
                      if out.pf_logits is not None else None)
        dec_tok_ids = (out.dec_logits.argmax(-1).cpu().numpy()
                       if out.dec_logits is not None else None)

        # ---- time accounting (suffix tokens only) ----
        pf_tok = int(sum(take for _, take, _ in chunks))
        if isinstance(self.clock, VirtualClock):
            swaps = store.swap_ins - self._swaps_seen[0]
            swap_bytes = store.swap_in_bytes - self._swaps_seen[1]
            self._swaps_seen = (store.swap_ins, store.swap_in_bytes)
            cost = self.clock.step_cost(pf_tok, len(self.active), 0,
                                        dec_extra_tokens=int(sum(
                                            len(d) for d in drafts.values())),
                                        adapter_swaps=swaps,
                                        adapter_swap_bytes=swap_bytes)
            self.clock.charge(cost)
            self.metrics.busy_time += cost
        now = self.clock.now()

        # ---- scatter results back ----
        cm.update(out.cache)
        if pf_reqs:
            assignments, lengths = [], []
            finals: List[Request] = []
            for i, (r, take, final) in enumerate(chunks):
                r.prefilled += take
                if r.recount_pending:
                    self.metrics.preempted_tokens_recomputed += take
                    if final:
                        r.recount_pending = False
                assignments.append((i, r.dec_slot))
                lengths.append(r.prefilled)
                if final:
                    tok = int(pf_tok_ids[i])
                    r.output.append(tok)
                    if r.t_first_token is None:
                        r.t_first_token = now
                    r.token_times.append(now)
                    r.state = State.DECODE
                    self._last_tokens[r.dec_slot] = tok
                    self.active[r.dec_slot] = r
                    self.prefilling.pop(r.dec_slot, None)
                    finals.append(r)
                else:
                    self.prefilling[r.dec_slot] = r
            # commit is the dedup publication point of the filled blocks
            cm.commit_prefill(assignments, lengths,
                              src_base=e.capacity if use_dec else 0)
            self.metrics.prefill_tokens += pf_tok
            self.metrics.max_pf_tokens_step = max(
                self.metrics.max_pf_tokens_step, pf_tok)
            for r in finals:
                self._maybe_finish(r, now)
        if use_dec:
            for slot, r in list(self.active.items()):
                if r.state is not State.DECODE or slot not in planned:
                    continue    # just prefilled this tick: no decode row
                if Sd > 1:
                    self._scatter_verify(slot, r, dec_tok_ids[slot],
                                         drafts[slot], now)
                    continue
                tok = int(dec_tok_ids[slot])
                r.output.append(tok)
                r.token_times.append(now)
                # position L holds the K/V of this step's INPUT token
                cm.commit_tokens(slot, [int(self._last_tokens[slot])])
                self._last_tokens[slot] = tok
                self.metrics.decode_tokens += 1
                self._maybe_finish(r, now)

        self.metrics.steps += 1
        self.metrics.elapsed = self.clock.now()
        self.metrics.probe_admissions += decision.probe_admissions
        self.metrics.adapter_swap_ins = store.swap_ins - self._swaps_base[0]
        self.metrics.adapter_swap_in_bytes = (store.swap_in_bytes
                                              - self._swaps_base[1])
        self.metrics.adapter_resident_hits = (store.resident_hits
                                              - self._swaps_base[2])
        self.metrics.adapter_peak_coresident = store.peak_coresident
        if self.paged:
            self.metrics.hash_hits = cm.hash_hits
            self.metrics.hash_blocks_resident = cm.hash_blocks_resident
        return True

    # ------------------------------------------------------- admission body
    def _admit_loop(self, decision, pf_reqs: List[flow.PFReq],
                    chunks: List[Tuple[Request, int, bool]],
                    budget_left: Optional[int], resolved: Dict[str, int],
                    unknown: set, resolve):
        e = self.ecfg
        cm = self.cachemgr
        for r in decision.admit:
            if len(pf_reqs) >= e.pf_capacity:
                break
            # resolve the adapter before reserving cache resources: a
            # saturated adapter defers only its own requests
            if r.adapter:
                resolve(r.adapter)
                if r.adapter in unknown:
                    r.state = State.FAILED
                    r.t_finish = self.clock.now()
                    self._drop_retain(r)
                    self.waiting.remove(r)
                    self.finished.append(r)
                    continue
                if r.adapter not in resolved:
                    continue
                aslot = resolved[r.adapter]
            else:
                aslot = -1
            if self.paged:
                adm = cm.try_admit(r.prompt, r.remaining_new, r.adapter,
                                   headroom=self._headroom_for(r),
                                   shareable=r.aux_embed is None,
                                   keys=self._keys_of(r),
                                   priority=r.priority_class)
                slot, reused = adm if adm is not None else (None, 0)
            else:
                slot = cm.alloc()
            if slot is None:
                break
            if r.adapter and not r.adapter_retained:
                # reprolint: ownership-transfer — the hold moves onto the
                # request; _drop_retain releases it at finish/failure
                self.model.store.retain(r.adapter)
                r.adapter_retained = True
            r.dec_slot = slot
            r.state = State.PREFILL
            if self.spec:
                kind = ("suffix" if (self.spec.drafter == "suffix"
                                     and r.draft_suffix is not None)
                        else "ngram")
                self._spec[slot] = (
                    make_drafter(kind, ngram_n=self.spec.ngram_n,
                                 suffix=r.draft_suffix),
                    AdaptiveK(self.spec))
            self.waiting.remove(r)
            if not self.paged:
                # dense rows: full-prompt recompute into the bucket's rows
                r.prefilled = 0
                pf_reqs.append(flow.PFReq(tokens=r.prompt, rid=r.rid,
                                          slot=aslot))
                chunks.append((r, r.prompt_len, True))
                continue
            # suffix-only prefill: the shared prefix is read through the
            # full block table; writes land at positions >= cached_len.  A
            # cold start keeps the prompt-local attention (cached_len=None)
            r.prefilled = reused
            suffix = r.prompt_len - r.prefilled
            take = suffix if budget_left is None else min(suffix,
                                                          budget_left)
            self.metrics.reused_prefix_tokens += reused
            if take <= 0:
                self.prefilling[slot] = r
                continue
            if budget_left is not None:
                budget_left -= take
            pf_reqs.append(flow.PFReq(
                tokens=r.prompt[r.prefilled:r.prefilled + take], rid=r.rid,
                slot=aslot,
                block_table=(cm.table_of(slot) if reused
                             else cm.write_table_of(slot)),
                cached_len=r.prefilled if reused else None))
            chunks.append((r, take, r.prefilled + take >= r.prompt_len))

    # ---------------------------------------------------------- preemption
    def _grow_or_preempt(self, slot: int, r: Request, L: int, n: int,
                         pinned: frozenset) -> int:
        """``prepare_write`` of the ``n`` chunk tokens from ``L``; when not
        even the committed token at ``L`` can be written (a copy-on-write
        found the pool dry), preempt the lowest-priority resident (possibly
        this one) and retry.  Returns the writable token count."""
        while True:
            try:
                writable = self.cachemgr.prepare_write(slot, L, n)
            except OutOfBlocksError:
                writable = 0
            if writable >= 1:
                return writable
            victim = self._pick_victim(exclude=pinned)
            if victim is None or victim == slot:
                self._preempt(slot)
                return 0
            self._preempt(victim)

    def _pick_victim(self, exclude: frozenset) -> Optional[int]:
        cands = [(s, r) for s, r in list(self.active.items())
                 + list(self.prefilling.items()) if s not in exclude]
        if not cands:
            return None
        return max(cands,
                   key=lambda it: (it[1].class_rank, it[1].arrival,
                                   0.0, it[1].rid))[0]

    def _preempt(self, slot: int):
        """Recompute preemption: roll the victim's emitted tokens into its
        prompt, free its blocks, requeue it at the head of ``waiting``."""
        r = self.active.pop(slot, None)
        if r is None:
            r = self.prefilling.pop(slot)
        if len(r.output) > r.rolled:
            r.prompt = np.concatenate(
                [np.asarray(r.prompt),
                 np.asarray(r.output[r.rolled:],
                            np.asarray(r.prompt).dtype)])
            r.rolled = len(r.output)
        r.prefilled = 0
        r.dec_slot = -1
        r.state = State.WAITING
        r.preemptions += 1
        r.recount_pending = True
        self._spec.pop(slot, None)
        self.cachemgr.free(slot)
        self.waiting.insert(0, r)
        self.metrics.preemptions += 1

    def _scatter_verify(self, slot: int, r: Request, arg: np.ndarray,
                        draft: np.ndarray, now: float):
        """Greedy acceptance for one verify chunk (``arg``: the chunk's
        argmax ids): keep the longest draft prefix matching the model's
        argmax plus the bonus token, then roll the paged cache back past the
        accepted length, releasing blocks the rejected drafts occupied."""
        L = int(self.cachemgr.lens[slot])
        n_acc, emitted = accept_greedy_ids(draft, arg)
        # exactness clamps: never emit past max_new_tokens, stop at eos:
        # the cuts plain greedy decode would have made tick by tick
        emitted = emitted[:r.max_new_tokens - len(r.output)]
        if r.eos_token >= 0 and r.eos_token in emitted:
            emitted = emitted[:emitted.index(r.eos_token) + 1]
        n_kept = len(emitted)
        t_prev = r.token_times[-1] if r.token_times else now
        r.token_times.extend(spread_token_times(t_prev, now, n_kept))
        r.output.extend(emitted)
        # the cache holds K/V of [current, accepted drafts]; the bonus token
        # is the next step's input.  Roll back the rejected positions, then
        # commit the accepted input tokens (which may publish blocks)
        self.cachemgr.truncate(slot, L + n_kept)
        self.cachemgr.commit_tokens(
            slot, [int(self._last_tokens[slot])] + list(emitted[:-1]))
        self._last_tokens[slot] = emitted[-1]
        self.metrics.decode_tokens += n_kept
        if len(draft):
            self.metrics.spec_drafted += len(draft)
            self.metrics.spec_accepted += n_acc
            self.metrics.spec_steps += 1
            self._spec[slot][1].update(len(draft), n_acc)
        self._maybe_finish(r, now)

    def _maybe_finish(self, r: Request, now: float):
        done_len = len(r.output) >= r.max_new_tokens
        eos = r.eos_token >= 0 and r.output and r.output[-1] == r.eos_token
        ctx_full = self.cachemgr.lens[r.dec_slot] + 1 >= self.ecfg.s_max
        if done_len or eos or ctx_full:
            r.state = State.DONE
            r.t_finish = now
            self.active.pop(r.dec_slot, None)
            self._spec.pop(r.dec_slot, None)
            self.cachemgr.free(r.dec_slot)
            self._drop_retain(r)
            self.finished.append(r)

    def _drop_retain(self, r: Request):
        if r.adapter and r.adapter_retained:
            self.model.store.release(r.adapter)
            r.adapter_retained = False

    # ------------------------------------------------------------------
    def run(self, max_ticks: int = 100000, until_drained: bool = True):
        """Run until all requests finish."""
        for _ in range(max_ticks):
            busy = self.tick()
            drained = (not self.waiting and not self.active
                       and not self.prefilling and not self.future)
            if until_drained and drained:
                break
            if not busy and not until_drained:
                break
        self.metrics.elapsed = self.clock.now()
        return self.metrics
