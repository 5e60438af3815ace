"""FleetFabric: N in-process ``UnifiedEngine`` replicas behind one router.

Port of ``repro.fleet.fabric``.  The fleet is a discrete-event simulation
over the replicas' own clocks: the fabric holds the global arrival-sorted
trace, routes every arrival that has come due against the earliest busy
replica's clock, then ticks whichever busy replica is furthest behind.  No
replica runs ahead of a routing decision it should have seen, so a trace
replays identically for a given policy under the virtual clock.  The
fleet's elapsed time is the max over the replica clocks.

Before a request is handed to its replica, the fabric looks up how much of
its block-key chain is resident anywhere in the fleet beyond what the
target holds, and applies the fetch-vs-recompute rule

    fixed + n * remote_per_block  <  n * block_size * prefill_per_tok

(one transfer launch over ``n`` blocks against recomputing their prefill).
When fetching wins, the blocks are copied from sibling pools into the
target's (``PagedCacheManager.import_block``, a copy on the card) and the
target's virtual clock is charged the modeled interconnect cost; its
admission then adopts them as if a local tenant had published them.  The
copies are of published, copy-on-write-immutable K/V, so the outputs equal
computing everything locally.

The replicas share the base weights by reference (``replicate_model``): a
replica costs an adapter bank and a KV pool on the card, never a second
copy of the base.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from repro_torch.core.virtualization import AdapterStore, MixedLoraModel
from repro_torch.fleet.index import FleetIndex
from repro_torch.fleet.router import Router, RouterConfig
from repro_torch.serving.clock import CostModel, VirtualClock
from repro_torch.serving.engine import EngineConfig, UnifiedEngine
from repro_torch.serving.kvcache import PagedCacheManager, request_chain_keys
from repro_torch.serving.request import Request
from repro_torch.serving.slo import Metrics


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    replicas: int = 2
    router: RouterConfig = dataclasses.field(default_factory=RouterConfig)
    remote_fetch: bool = True    # False: independent replicas (the index
    #                              still mirrors, dispatch never imports)

    def __post_init__(self):
        if self.replicas < 1:
            raise ValueError("fleet needs at least one replica")


@dataclasses.dataclass
class FleetMetrics:
    """Fleet-wide rollup: counters summed, elapsed = max replica clock."""
    elapsed: float = 0.0
    decode_tokens: int = 0
    prefill_tokens: int = 0
    reused_prefix_tokens: int = 0
    finetune_tokens: int = 0
    steps: int = 0
    busy_time: float = 0.0
    hash_hits: int = 0
    remote_fetch_blocks: int = 0
    remote_fetch_time: float = 0.0
    preemptions: int = 0
    routed: Dict[int, int] = dataclasses.field(default_factory=dict)
    per_engine: List[Metrics] = dataclasses.field(default_factory=list)

    def rates(self):
        e = max(self.elapsed, 1e-9)
        return {"DTPS": self.decode_tokens / e,
                "PTPS": self.prefill_tokens / e,
                "FTPS": self.finetune_tokens / e,
                "steps_per_s": self.steps / e}


def replicate_model(model: MixedLoraModel, n: int) -> List[MixedLoraModel]:
    """``n`` virtual models over one set of base weights (replica 0 is the
    original).  The base is shared by reference; each extra replica gets
    its own ``AdapterStore`` on the source store's device and dtype, loaded
    with copies of every adapter the source holds (resident ones in slot
    order, then voided ones), each with its scale and true rank, so every
    replica computes the same K/V and logits for the same rows.  The
    copies own their storage: training on one replica leaves the others'
    banks alone."""
    out = [model]
    src = model.store
    for _ in range(1, n):
        store = AdapterStore(model.cfg, src.lcfg, device=src.device,
                             dtype=src.dtype)
        for name in src.resident:
            store.load(name, src.get_adapter(name),
                       scale=float(src.scale[src.slot_of(name)]),
                       rank=src._ranks.get(name))
        for name, v in src._voided.items():
            # a small bank evicts overflow to host before the fleet is
            # built, and every replica must serve every adapter
            store.load(name, v.adapter, scale=v.scale, evict=True,
                       rank=src._ranks.get(name))
        out.append(MixedLoraModel(model.cfg, model.base, store))
    return out


def build_fleet(model: MixedLoraModel, ecfg: EngineConfig,
                fcfg: Optional[FleetConfig] = None) -> "FleetFabric":
    """The one-call constructor of the serve CLI."""
    fcfg = fcfg or FleetConfig()
    models = replicate_model(model, fcfg.replicas)
    return FleetFabric([UnifiedEngine(m, ecfg) for m in models], fcfg)


class FleetFabric:
    def __init__(self, engines: Sequence[UnifiedEngine],
                 fcfg: Optional[FleetConfig] = None):
        if not engines:
            raise ValueError("fleet needs at least one engine")
        self.engines = list(engines)
        self.fcfg = fcfg or FleetConfig(replicas=len(engines))
        self.router = Router(self.engines, self.fcfg.router)
        self.index = FleetIndex()
        for eid, eng in enumerate(self.engines):
            if isinstance(eng.cachemgr, PagedCacheManager) and eng.hash_dedup:
                self.index.attach(eid, eng.cachemgr)
        self.future: List[Request] = []       # arrival-sorted global trace
        self.routed: Dict[int, int] = {eid: 0 for eid in
                                       range(len(self.engines))}

    def submit(self, r: Request):
        self.future.append(r)
        self.future.sort(key=lambda q: q.arrival)

    def _busy(self, eng: UnifiedEngine) -> bool:
        return bool(eng.waiting or eng.active or eng.prefilling
                    or eng.future or eng.trainers_pending())

    @property
    def drained(self) -> bool:
        return not self.future and not any(self._busy(e)
                                           for e in self.engines)

    # -- dispatch --------------------------------------------------------
    def _fetch_prefix(self, eid: int, r: Request) -> int:
        """Import the request's fleet-resident, locally missing prefix
        blocks into replica ``eid``'s pool when the fetch-vs-recompute rule
        says the transfer beats local prefill.  Returns the blocks fetched
        and charges them to the replica's virtual clock."""
        eng = self.engines[eid]
        mgr = eng.cachemgr
        if (not self.fcfg.remote_fetch
                or not isinstance(mgr, PagedCacheManager)
                or not eng.hash_dedup or r.aux_embed is not None):
            return 0
        keys = request_chain_keys(r, mgr.block_size)
        local = len(mgr._resident_run(keys))
        fleet_run = self.index.resident_run(keys)
        n = fleet_run - local
        if n <= 0:
            return 0
        clock = eng.clock
        cost = (clock.cost if isinstance(clock, VirtualClock)
                else CostModel())
        if (cost.fixed + n * cost.remote_per_block
                >= n * mgr.block_size * cost.prefill_per_tok):
            return 0          # launch overhead eats the win: recompute
        fetched = 0
        for key in keys[local:fleet_run]:
            where = self.index.locate(key, prefer=eid)
            if where is None:
                break                       # shed between probe and fetch
            src_eid, src_bid = where
            if src_eid == eid:
                continue                    # already local (mid-chain hit)
            if mgr.import_block(key, self.engines[src_eid].cachemgr,
                                src_bid) is None:
                break          # no spendable capacity; the chain must stay
                #                gapless, so stop here
            fetched += 1
        if fetched and isinstance(clock, VirtualClock):
            t = clock.step_cost(0, 0, 0, remote_blocks=fetched)
            clock.charge(t)
            eng.metrics.remote_fetch_time += t
            eng.metrics.busy_time += t
        return fetched

    def _dispatch(self, r: Request):
        eid = self.router.route(r)
        self.routed[eid] += 1
        self._fetch_prefix(eid, r)
        self.engines[eid].submit(r)

    # -- event loop ------------------------------------------------------
    def tick(self) -> bool:
        """Route due arrivals, then tick the furthest-behind busy replica;
        False when the whole fleet is idle."""
        busy = [e for e in self.engines if self._busy(e)]
        if not busy and not self.future:
            return False
        horizon = (min(e.clock.now() for e in busy) if busy
                   else self.future[0].arrival)
        while self.future and self.future[0].arrival <= horizon:
            self._dispatch(self.future.pop(0))
        busy = [(e.clock.now(), i) for i, e in enumerate(self.engines)
                if self._busy(e)]
        if not busy:
            return bool(self.future)
        _, eid = min(busy)
        self.engines[eid].tick()
        return True

    def run(self, max_ticks: int = 1000000,
            until_drained: bool = True) -> FleetMetrics:
        for _ in range(max_ticks):
            alive = self.tick()
            if until_drained and self.drained:
                break
            if not alive and not until_drained:
                break
        for eng in self.engines:
            for tr in eng.trainers.values():
                if tr.force_apply_pending():
                    eng._apply_trainer(tr)
            eng.metrics.elapsed = eng.clock.now()
        return self.rollup()

    # -- metrics ---------------------------------------------------------
    def rollup(self) -> FleetMetrics:
        fm = FleetMetrics(routed=dict(self.routed),
                          per_engine=[e.metrics for e in self.engines])
        for eng in self.engines:
            m = eng.metrics
            fm.elapsed = max(fm.elapsed, eng.clock.now())
            fm.decode_tokens += m.decode_tokens
            fm.prefill_tokens += m.prefill_tokens
            fm.reused_prefix_tokens += m.reused_prefix_tokens
            fm.finetune_tokens += m.finetune_tokens
            fm.steps += m.steps
            fm.busy_time += m.busy_time
            fm.hash_hits += m.hash_hits
            fm.remote_fetch_blocks += m.remote_fetch_blocks
            fm.remote_fetch_time += m.remote_fetch_time
            fm.preemptions += m.preemptions
        return fm

    @property
    def all_requests(self) -> List[Request]:
        out: List[Request] = list(self.future)
        for eng in self.engines:
            out.extend(eng.all_requests)
        return out
