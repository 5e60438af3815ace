"""FleetIndex: the fleet-wide content-hash block index.

Port of ``repro.fleet.index``.  One map ``block_key -> {engine_id:
block_id}`` over every replica's local dedup index
(``PagedCacheManager._index``), fed by the managers' ``on_publish`` /
``on_depublish`` hooks, which fire on every local index change:
publication at prefill and decode commits, rehydration, remote import, and
retraction from ``_depublish`` (the one local removal path; copy-on-write
and truncate never change the index, since published payloads are
immutable).  An entry ``(key, engine, block)`` exists iff that engine's
local index holds that block under that key, so a fleet lookup never names
a dead, rewritten or shed block.

A prompt whose prefix is resident anywhere in the fleet can then fetch the
payload blocks into its local pool (``PagedCacheManager.import_block``, a
copy on the card charged at the modeled interconnect cost) instead of
recomputing them: the key is the content, so a copy from any holder equals
local recompute.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.serving.kvcache import PagedCacheManager


class FleetIndex:
    """``block_key -> {engine_id: block_id}`` across attached managers."""

    def __init__(self):
        self._where: Dict[str, Dict[int, int]] = {}
        self._mgrs: Dict[int, PagedCacheManager] = {}

    def attach(self, engine_id: int, mgr: PagedCacheManager) -> None:
        """Subscribe to ``mgr``'s publication hooks and ingest what its
        local index already holds (attaching after warm-up is legal)."""
        if engine_id in self._mgrs:
            raise ValueError(f"engine {engine_id} already attached")
        if mgr.on_publish is not None or mgr.on_depublish is not None:
            raise ValueError("manager already feeds another fleet index")
        self._mgrs[engine_id] = mgr
        mgr.on_publish = lambda key, bid: self._publish(engine_id, key, bid)
        mgr.on_depublish = lambda key, bid: self._retract(engine_id, key,
                                                          bid)
        for key, bid in mgr._index.items():
            self._publish(engine_id, key, bid)

    # -- hook targets ----------------------------------------------------
    def _publish(self, engine_id: int, key: str, bid: int) -> None:
        self._where.setdefault(key, {})[engine_id] = bid

    def _retract(self, engine_id: int, key: str, bid: int) -> None:
        holders = self._where.get(key)
        if holders is None or holders.get(engine_id) != bid:
            raise RuntimeError(     # a retraction never published
                f"fleet index drift: retract of unknown ({key!r:.12}, "
                f"engine {engine_id}, block {bid})")
        del holders[engine_id]
        if not holders:
            del self._where[key]

    # -- queries ---------------------------------------------------------
    def __len__(self) -> int:
        return len(self._where)

    @property
    def entries(self) -> int:
        """(key, engine) pairs: one key on two engines counts twice."""
        return sum(len(h) for h in self._where.values())

    def holders(self, key: str) -> List[Tuple[int, int]]:
        """Every ``(engine_id, block_id)`` holding ``key``'s payload."""
        return sorted(self._where.get(key, {}).items())

    def locate(self, key: str, prefer: Optional[int] = None
               ) -> Optional[Tuple[int, int]]:
        """One holder of ``key``: ``prefer``'s copy when it has one, else
        the lowest engine id; None when no engine holds it."""
        holders = self._where.get(key)
        if not holders:
            return None
        if prefer is not None and prefer in holders:
            return prefer, holders[prefer]
        eid = min(holders)
        return eid, holders[eid]

    def resident_run(self, keys: Sequence[str]) -> int:
        """Longest leading run of ``keys`` resident anywhere in the fleet.
        The walk stops at the first gap: a resident child behind a missing
        parent is unreachable (its chained key pins the parent's content,
        which would have to be recomputed anyway)."""
        n = 0
        for k in keys:
            if k not in self._where:
                break
            n += 1
        return n

    # -- integrity -------------------------------------------------------
    def check_bijection(self) -> None:
        """Every fleet entry resolves to a live local index entry and vice
        versa: the no-stale-entries invariant."""
        for key, holders in self._where.items():
            for eid, bid in holders.items():
                if self._mgrs[eid]._index.get(key) != bid:
                    raise AssertionError(
                        f"fleet entry ({key!r:.12}, engine {eid}, block "
                        f"{bid}) has no live local index entry")
        for eid, mgr in self._mgrs.items():
            for key, bid in mgr._index.items():
                if self._where.get(key, {}).get(eid) != bid:
                    raise AssertionError(
                        f"local index entry ({key!r:.12}, engine {eid}, "
                        f"block {bid}) missing from the fleet index")
