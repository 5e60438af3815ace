"""UnifiedEngine — the Loquetier runtime: serving and fine-tuning in one
step.

Every tick assembles ONE unified batch (fine-tune/eval rows + prefill +
decode or verify), executes ONE step (forward only, or forward and backward
with respect to the LoRA bank when the tick carries ft rows), then scatters
sampled tokens back to the requests, per-row losses to their trainers, and
accumulated gradients to the masked optimizer on each trainer's
accumulation boundary.  Port of ``repro.serving.engine`` with its default
settings: paged
KV, ``block_size=32``, content-hash dedup on, suffix-only prefill over
adopted prefixes, and speculative decoding under ``EngineConfig.spec``
(model-free drafters, ``(1 + k)``-token verify chunks, exact greedy
acceptance, rollback through ``PagedCacheManager.truncate``).  With
``EngineConfig(paged=False)`` (or a sliding-window model) it serves on dense
rows (``CacheManager``) as the JAX engine does: a slot per request, every
prompt prefilled whole, no table growth, no dedup, no suffix or chunked
prefill and no speculation.  A model with a Mamba layer in its pattern
keeps the paged pool and dedup (adopted blocks are shared storage) but,
as in the JAX engine, recomputes every prompt whole through
``write_table_of`` (its state must see every prompt token), takes no
chunked prefill, no host-tier swap-out (recompute-only preemption;
demotion of index blocks stays on) and no speculation.  Tensors live on the model's device; the model
writes the cache in place, so ``cachemgr.update`` swaps nothing.

Like the JAX step, a tick with ft rows runs its backward before its decode
tokens are scattered.

The memory features are the JAX engine's:

* ``over_admit > 1`` lends reservation debt to new admissions; a decode
  row whose block growth comes up short preempts the lowest-priority
  resident (``_pick_victim``: class, then arrival, then speculative
  acceptance), which rolls its output into its prompt and waits at the
  head of the queue;
* ``kv_host_blocks > 0`` adds the host tier: a victim's blocks swap out to
  pinned host memory when ``swap_beats_recompute`` says the transfer wins
  (every decision is logged in ``swap_decisions``) and are restored at its
  re-admission; shed index blocks demote to host and rehydrate.  The bytes
  moved are charged to the virtual clock;
* ``adapter_paging`` binds the adapter store to the KV pool
  (``AdapterStore.attach_pager``), so adapters page through the same
  blocks and the scheduler prefers requests whose adapter is resident.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import flow
from repro_torch.core.unified import make_apply_step, make_forward_step, \
    make_grad_step
from repro_torch.core.virtualization import MixedLoraModel
from repro_torch.models.model import cache_seq_len
from repro_torch.serving.clock import CostModel, VirtualClock, WallClock
from repro_torch.serving.kvcache import (CacheManager, OutOfBlocksError,
                                         PagedCacheManager,
                                         request_chain_keys,
                                         swap_beats_recompute)
from repro_torch.serving.request import Request, State
from repro_torch.serving.scheduler import Scheduler, SchedulerConfig
from repro_torch.serving.slo import Metrics, SLOConfig, spread_token_times
from repro_torch.spec import AdaptiveK, Drafter, accept_greedy_ids, \
    make_drafter
from repro_torch.training.optimizer import AdamWConfig, adamw_init, \
    tree_add, tree_mask_slots, tree_zeros_like
from repro_torch.training.trainer import MixedLoraTrainer


@dataclasses.dataclass
class EngineConfig:
    capacity: int = 8                 # max concurrent decode requests
    pf_capacity: int = 4              # prefill rows per tick
    s_max: int = 256                  # cache sequence capacity
    scheduler: SchedulerConfig = dataclasses.field(default_factory=SchedulerConfig)
    slo: SLOConfig = dataclasses.field(default_factory=SLOConfig)
    flow: flow.FlowConfig = dataclasses.field(default_factory=flow.FlowConfig)
    opt: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)
    attn_chunk: int = 0
    virtual_time: bool = False        # deterministic trace replay
    paged: bool = True                # block-table KV layout (False: dense
    #                                   rows; keep s_max a padded prompt
    #                                   bucket there, see UnifiedEngine)
    block_size: int = 32              # KV tokens per block
    n_blocks: int = 0                 # pool size; 0 = match dense capacity
    over_admit: float = 1.0           # reservation lending factor (>= 1)
    spec: Optional[object] = None     # spec.SpecConfig (speculation)
    prefill_chunk: int = 0            # per-tick prefill-token budget
    hash_dedup: bool = True           # content-hash block dedup
    adapter_paging: bool = False      # adapters page through the KV pool
    cost: Optional[CostModel] = None  # virtual-clock cost model override
    kv_host_blocks: int = 0           # host KV tier, in device blocks' worth
    kv_host_quant: bool = False       # int8 host residency (not bit-exact)


class UnifiedEngine:
    def __init__(self, model: MixedLoraModel,
                 ecfg: Optional[EngineConfig] = None):
        self.model = model
        self.ecfg = ecfg or EngineConfig()
        self.cfg = model.cfg
        e = self.ecfg
        self.device = model.store.device
        # final_norm is never quantized: the params' float dtype and device
        dtype = model.base["final_norm"].dtype
        if model.base["final_norm"].device.type != self.device.type:
            raise ValueError("base params and adapter bank live on "
                             "different devices")
        self.paged = e.paged and self.cfg.sliding_window == 0
        self._cost = e.cost or CostModel()
        if self.paged:
            self.cachemgr = PagedCacheManager(
                self.cfg, e.capacity, e.pf_capacity, e.s_max,
                device=self.device, dtype=dtype, block_size=e.block_size,
                n_blocks=e.n_blocks, over_admit=e.over_admit,
                hash_dedup=e.hash_dedup, host_blocks=e.kv_host_blocks,
                host_quant=e.kv_host_quant, cost=self._cost)
        else:
            self.cachemgr = CacheManager(self.cfg, e.capacity,
                                         e.pf_capacity, e.s_max,
                                         device=self.device, dtype=dtype)
            sc = cache_seq_len(self.cfg, e.s_max)
            over = flow._pad_seq(e.s_max, e.flow)
            if over > sc:
                # as in the JAX model, a prompt bucket longer than the row
                # is written rolling: the bucket's last sc positions land
                # at slots p % sc, so a prompt that does not fill its
                # bucket has padding where decode reads keys (ROADMAP
                # Queue 3)
                W = self.cfg.sliding_window
                msg = (f"dense rows of {sc} slots (sliding window {W}): a "
                       f"prompt whose padded prompt bucket is longer than "
                       f"{sc} tokens and which does not fill that bucket "
                       f"takes the JAX model's rolling write, so the "
                       f"bucket's padding lands on slots that decode reads "
                       f"as keys" if sc < e.s_max else
                       f"dense rows of {sc} slots: a prompt that pads to "
                       f"the {over}-token bucket has its first slots "
                       f"overwritten by the bucket's padding; choose an "
                       f"s_max that is a padded prompt bucket")
                warnings.warn(msg, RuntimeWarning, stacklevel=2)
        # unified adapter paging: adapter weights share the KV block pool
        self.adapter_paging = self.paged and e.adapter_paging
        if self.adapter_paging:
            model.store.attach_pager(self.cachemgr)
        st = model.store
        self._swaps_base = (st.swap_ins, st.swap_in_bytes, st.resident_hits)
        self._swaps_seen = self._swaps_base[:2]
        self.sched = Scheduler(e.scheduler, e.capacity)
        self.clock = VirtualClock(e.cost) if e.virtual_time else WallClock()
        self.metrics = Metrics()
        # paged rows prefill suffix-only: shared-prefix K/V is read through
        # the block tables instead of recomputed, and long prompts may
        # prefill in chunks.  Both need a positional cache: a Mamba layer's
        # state cannot resume mid-prompt from blocks, so a pattern with one
        # recomputes every prompt whole, as dense rows do
        self.suffix_prefill = self.paged and "mamba" not in self.cfg.pattern
        self.chunk_budget = (e.prefill_chunk
                             if e.prefill_chunk > 0 and self.suffix_prefill
                             else 0)
        self.prefilling: Dict[int, Request] = {}  # slot -> partial prefill
        self.hash_dedup = self.paged and e.hash_dedup
        # host tier: swap-outs pay off only through suffix prefill, so a
        # model that recomputes whole prompts keeps recompute-only
        # preemption; demotion of index blocks rides the adoption path and
        # stays on
        self.kv_tiering = (self.paged and e.kv_host_blocks > 0
                           and self.suffix_prefill)
        self._kv_seen = (0, 0)                 # (d2h, h2d) bytes charged
        self.swap_decisions: List[dict] = []   # every swap-vs-recompute
        self.forward_step = make_forward_step(self.cfg,
                                              block_t=e.flow.block_t,
                                              attn_chunk=e.attn_chunk)
        self.grad_step = make_grad_step(self.cfg, block_t=e.flow.block_t,
                                        attn_chunk=e.attn_chunk)
        self.apply_step = make_apply_step(e.opt)
        self.opt_state = adamw_init(st.bank, st.lcfg.n_slots)
        self.grad_accum = tree_zeros_like(st.bank)
        self.future: List[Request] = []       # arrival-sorted
        self.waiting: List[Request] = []
        self.active: Dict[int, Request] = {}  # decode slot -> request
        self.finished: List[Request] = []
        self.trainers: Dict[str, MixedLoraTrainer] = {}
        self._last_tokens = np.zeros((e.capacity,), np.int64)
        # speculative decoding: rollback-able K/V (paged blocks) and a
        # positional cache; Mamba state cannot un-consume drafts
        self.spec = e.spec if (e.spec is not None and e.spec.enabled
                               and self.paged
                               and "mamba" not in self.cfg.pattern) else None
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

    def add_trainer(self, tr: MixedLoraTrainer):
        self.trainers[tr.name] = tr
        # training adapters must never be evicted: their slot identity is
        # baked into the trainer mask and optimizer state
        # reprolint: ownership-transfer — pin lives for the trainer's life
        self.model.store.pin(tr.name)

    def trainers_pending(self) -> bool:
        return any(t.pending() for t in self.trainers.values())

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
                    aux_embed=r.aux_embed,
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
                    self._drop_swap(r)
                    self.waiting.remove(r)
                    self.finished.append(r)
            decision = self.sched.decide(
                self.waiting, len(self.active) + len(self.prefilling),
                cm.n_free, e.pf_capacity, self.trainers_pending(),
                free_blocks=cm.free_blocks + cm.reclaimable_blocks,
                total_blocks=cm.total_blocks, block_size=cm.block_size,
                s_max=e.s_max,
                need_fn=lambda r: cm.fresh_need(
                    r.prompt_len, r.remaining_new, r.prompt, r.adapter,
                    headroom=self._headroom_for(r), keys=self._keys_of(r),
                    shareable=r.aux_embed is None),
                spec_headroom=self.spec_headroom,
                pf_rows_used=len(pf_reqs), pf_token_budget=budget_left,
                suffix_fn=((lambda r: r.prompt_len
                            - self._resident_tokens(r))
                           if self.suffix_prefill else None),
                chunked=bool(self.chunk_budget),
                # the lent fraction makes fine-tuning yield before
                # inference is preempted
                lent_frac=cm.lent_blocks / max(cm.reserved_debt, 1),
                probe_fn=self._resident_tokens if self.hash_dedup else None,
                adapter_fn=((lambda r: self.model.store.is_resident(
                    r.adapter)) if self.adapter_paging else None),
                now=self.clock.now())
        else:
            # dense rows: a free slot is the whole admission gate
            decision = self.sched.decide(self.waiting, len(self.active),
                                         cm.n_free, e.pf_capacity,
                                         self.trainers_pending())

        # fine-tuning rows (round-robin over trainers)
        ft_rows: List[flow.FTRow] = []
        budget = decision.ft_rows
        for tr in self.trainers.values():
            if budget <= 0:
                break
            got = tr.next_rows(budget)
            ft_rows.extend(got)
            budget -= len(got)

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

        if not ft_rows and not pf_reqs and not use_dec:
            if self.future:
                self.clock.advance_to(self.future[0].arrival)
                return True
            return False

        batch = flow.assemble(ft_rows, pf_reqs, dec_tokens, dec_pos,
                              dec_slots, e.flow, self.device,
                              dec_tables=dec_tables, dec_lens=dec_lens)
        if pf_reqs and self.active and batch.dec is None:
            self.metrics.starved_ticks += 1
        cache = cm.step_cache() if (pf_reqs or use_dec) else None
        store = self.model.store
        if ft_rows:
            res = self.grad_step(self.model.base, store.bank, store.scale,
                                 batch, cache)
            out, grads = res.out, res.grads
        else:
            out = self.forward_step(self.model.base, store.bank, store.scale,
                                    batch, cache)
            grads = None
        # the one step barrier: greedy tokens drive the next tick's inputs
        # (argmax on the device, only token ids cross to the host; [Bd, Sd]
        # of them for verify chunks)
        pf_tok_ids = (out.pf_logits.argmax(-1).cpu().numpy()
                      if out.pf_logits is not None else None)
        dec_tok_ids = (out.dec_logits.argmax(-1).cpu().numpy()
                       if out.dec_logits is not None else None)

        # ---- time accounting (suffix tokens only) ----
        pf_tok = int(sum(take for _, take, _ in chunks))
        ft_tok = int(sum(len(r.tokens) for r in ft_rows))
        if isinstance(self.clock, VirtualClock):
            swaps = store.swap_ins - self._swaps_seen[0]
            swap_bytes = store.swap_in_bytes - self._swaps_seen[1]
            self._swaps_seen = (store.swap_ins, store.swap_in_bytes)
            # host-tier bytes since the last charge
            kvd = kvh = 0
            if self.paged:
                kvd = cm.kv_d2h_bytes - self._kv_seen[0]
                kvh = cm.kv_h2d_bytes - self._kv_seen[1]
                self._kv_seen = (cm.kv_d2h_bytes, cm.kv_h2d_bytes)
            cost = self.clock.step_cost(pf_tok, len(self.active), ft_tok,
                                        dec_extra_tokens=int(sum(
                                            len(d) for d in drafts.values())),
                                        adapter_swaps=swaps,
                                        adapter_swap_bytes=swap_bytes,
                                        kv_d2h_bytes=kvd, kv_h2d_bytes=kvh)
            self.clock.charge(cost)
            self.metrics.busy_time += cost
        now = self.clock.now()

        # ---- scatter results back ----
        if out.cache is not None:
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

        if ft_rows:
            # per-trainer loss bookkeeping on the host once per step
            losses = out.ft_loss_sum.cpu().numpy()
            counts = out.ft_tok_count.cpu().numpy()
            per_row = losses / np.maximum(counts, 1.0)
            self.grad_accum = tree_add(self.grad_accum, grads)
            by_trainer: Dict[str, List] = {}
            train_tok = eval_tok = 0.0
            for i, row in enumerate(ft_rows):
                by_trainer.setdefault(row.trainer, []).append(
                    (row, float(per_row[i]), float(counts[i])))
                if row.is_eval:
                    eval_tok += float(counts[i])
                else:
                    train_tok += float(counts[i])
            for name, items in by_trainer.items():
                tr = self.trainers[name]
                if tr.record([it[0] for it in items],
                             [it[1] for it in items],
                             [it[2] for it in items]):
                    self._apply_trainer(tr)
            self.metrics.finetune_tokens += int(train_tok)
            self.metrics.eval_tokens += int(eval_tok)

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
            self.metrics.lent_blocks_peak = cm.lent_blocks_peak
            self.metrics.hash_hits = cm.hash_hits
            self.metrics.hash_blocks_resident = cm.hash_blocks_resident
            self.metrics.remote_fetch_blocks = cm.remote_imports
            if cm.host_pool is not None:
                hp = cm.host_pool
                self.metrics.kv_swap_outs = cm.kv_swap_outs
                self.metrics.kv_swap_out_bytes = cm.kv_swap_out_bytes
                self.metrics.kv_restores = cm.kv_restores
                self.metrics.kv_restore_bytes = cm.kv_restore_bytes
                self.metrics.kv_demotions = cm.kv_demotions
                self.metrics.kv_rehydrated_blocks = cm.kv_rehydrations
                self.metrics.host_bytes_used = hp.used_bytes
                self.metrics.host_bytes_peak = hp.peak_used_bytes
            if self.adapter_paging:
                self.metrics.adapter_blocks_resident = \
                    cm.adapter_blocks_resident
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
                    self._drop_swap(r)
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
            if r.swap_sid is not None:
                # re-admission of a swapped-out victim: the restore covers
                # its rolled context but one live token, so suffix prefill
                # recomputes exactly that token
                restored = cm.restore_swap(slot, r.swap_sid)
                r.swap_sid = None
                if restored > reused:
                    self.metrics.kv_restored_tokens += restored - reused
                    reused = restored
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
            if not self.suffix_prefill:
                # full-prompt recompute (dense rows, or a Mamba pattern
                # whose state must see every prompt token): a paged row
                # writes through write_table_of, so adopted prefix entries
                # are nulled and prefill never rewrites a block it does not
                # own
                r.prefilled = 0
                pf_reqs.append(flow.PFReq(
                    tokens=r.prompt, rid=r.rid, slot=aslot,
                    aux_embed=r.aux_embed,
                    block_table=(cm.write_table_of(slot) if self.paged
                                 else None)))
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
                slot=aslot, aux_embed=r.aux_embed,
                block_table=(cm.table_of(slot) if reused
                             else cm.write_table_of(slot)),
                cached_len=r.prefilled if reused else None))
            chunks.append((r, take, r.prefilled + take >= r.prompt_len))

    # ---------------------------------------------------------- preemption
    def _grow_or_preempt(self, slot: int, r: Request, L: int, n: int,
                         pinned: frozenset) -> int:
        """``prepare_write`` of the ``n`` chunk tokens from ``L``; when not
        even the committed token at ``L`` can be written (a lent reservation
        came due, or a copy-on-write found the pool dry), preempt the
        lowest-priority resident (possibly this one) and retry.  ``pinned``
        slots hold prefill rows of this tick.  Returns the writable token
        count."""
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
        """Lowest-priority resident: batch class before standard,
        interactive last; within a class the latest arrival, then the
        lowest speculative acceptance rate, then the latest rid."""
        cands = [(s, r) for s, r in list(self.active.items())
                 + list(self.prefilling.items()) if s not in exclude]
        if not cands:
            return None

        def badness(item):
            s, r = item
            ctl = self._spec.get(s)
            acc = ctl[1].rate if ctl is not None else 0.0
            return (r.class_rank, r.arrival, -acc, r.rid)

        return max(cands, key=badness)[0]

    def _preempt(self, slot: int):
        """Preemption: roll the victim's emitted tokens into its prompt,
        swap its blocks to host when that wins (else they are recomputed),
        free them and requeue it at the head of ``waiting``.  It keeps its
        arrival, first-token time and adapter hold."""
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
        if self.kv_tiering:
            # before free(): the gather reads the table
            r.swap_sid = self._maybe_swap_out(slot, r)
        self.cachemgr.free(slot)
        self.waiting.insert(0, r)
        self.metrics.preemptions += 1

    def _maybe_swap_out(self, slot: int, r: Request) -> Optional[int]:
        """Price one victim's swap with the cost model and take it only when
        it wins; every decision goes into ``swap_decisions``.  The
        recompute side counts the committed tokens minus the blocks other
        holders keep on the device through the free."""
        m = self.cachemgr
        nb = m.swap_payload_blocks(slot)
        tokens = int(m.lens[slot])
        surviving = m.surviving_blocks(slot, nb)
        recompute = max(tokens - surviving * m.block_size, 0)
        stored = nb * m.host_block_bytes
        chose = nb > 0 and swap_beats_recompute(stored, recompute,
                                                self._cost)
        sid = m.swap_out(slot) if chose else None
        self.swap_decisions.append({
            "rid": r.rid, "tokens": tokens, "blocks": nb,
            "stored_bytes": stored, "recompute_tokens": recompute,
            "chose_swap": bool(chose), "swapped": sid is not None})
        if sid is None:
            self.metrics.kv_swap_skips += 1
        return sid

    def _drop_swap(self, r: Request):
        """Release the request's host swap set, if any, exactly once."""
        if r.swap_sid is not None and self.paged:
            self.cachemgr.drop_swap(r.swap_sid)
            r.swap_sid = None

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

    def _apply_trainer(self, tr: MixedLoraTrainer):
        store = self.model.store
        mask = store.slot_mask([tr.name])
        new_bank, self.opt_state = self.apply_step(self.grad_accum,
                                                   self.opt_state,
                                                   store.bank, mask)
        store.set_bank(new_bank)
        store.mark_dirty(tr.name)
        self.grad_accum = tree_mask_slots(self.grad_accum, 1.0 - mask)

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
        """Run until all inference requests finish and trainers complete."""
        for _ in range(max_ticks):
            busy = self.tick()
            drained = (not self.waiting and not self.active
                       and not self.prefilling and not self.future
                       and not self.trainers_pending())
            if until_drained and drained:
                break
            if not busy and not until_drained:
                break
        for tr in self.trainers.values():
            if tr.force_apply_pending():
                self._apply_trainer(tr)
        self.metrics.elapsed = self.clock.now()
        return self.metrics

    @property
    def all_requests(self) -> List[Request]:
        return self.finished + list(self.active.values()) \
            + list(self.prefilling.values()) + self.waiting + self.future
