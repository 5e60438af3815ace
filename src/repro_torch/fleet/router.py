"""Front-end request router of the in-process engine fleet.

Port of ``repro.fleet.router``.  Three policies over N ``UnifiedEngine``
replicas:

* ``round-robin``: arrival order modulo N, the locality-blind baseline;
* ``least-loaded``: fewest resident + queued requests, ties to the lowest
  engine id;
* ``affinity``: the argmax of

      score = resident_prefix_fraction            # in [0, 1]
            + adapter_bonus * adapter_resident    # LoRA already in the bank
            - load_penalty * queue_depth          # unbounded with depth
            - lent_penalty * lent_block_fraction  # over-admission pressure

  The affinity terms are bounded and the load penalty is not, so a hot
  replica holding every popular template still loses the argmax once its
  backlog grows: the policy cannot herd the whole trace onto one engine.
  Prefix residency reuses the request's memoized chain keys, so the probe
  and the chosen engine's admission hash each prompt once between them.

The router only scores; the remote prefix fetch into the chosen replica's
pool belongs to the fabric's dispatch.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

from repro_torch.serving.engine import UnifiedEngine
from repro_torch.serving.kvcache import PagedCacheManager, request_chain_keys
from repro_torch.serving.request import Request

POLICIES = ("affinity", "round-robin", "least-loaded")


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    policy: str = "affinity"
    adapter_bonus: float = 0.25   # worth a quarter-prompt of resident prefix
    load_penalty: float = 0.125   # per queued/resident request: unbounded
    #                               growth is the anti-herding guarantee
    lent_penalty: float = 0.25    # per unit lent-block fraction

    def __post_init__(self):
        if self.policy not in POLICIES:
            raise ValueError(f"unknown router policy {self.policy!r}; "
                             f"choose one of {POLICIES}")


def queue_depth(eng: UnifiedEngine) -> int:
    """Requests a replica is committed to: resident, queued, and
    dispatched but not yet due (the fabric hands a request to an engine's
    ``future`` when it routes it)."""
    return (len(eng.waiting) + len(eng.active) + len(eng.prefilling)
            + len(eng.future))


class Router:
    def __init__(self, engines: Sequence[UnifiedEngine],
                 cfg: Optional[RouterConfig] = None):
        if not engines:
            raise ValueError("router needs at least one engine")
        self.engines = list(engines)
        self.cfg = cfg or RouterConfig()
        self._rr = 0

    # -- affinity scoring ------------------------------------------------
    def _prefix_fraction(self, eng: UnifiedEngine, r: Request) -> float:
        mgr = eng.cachemgr
        if (not isinstance(mgr, PagedCacheManager) or not eng.hash_dedup
                or r.aux_embed is not None or r.prompt_len == 0):
            return 0.0
        keys = request_chain_keys(r, mgr.block_size)
        return mgr.probe(r.prompt, r.adapter, keys=keys) / r.prompt_len

    def score(self, eng: UnifiedEngine, r: Request) -> float:
        c = self.cfg
        s = self._prefix_fraction(eng, r)
        if r.adapter and r.adapter in eng.model.store.resident:
            s += c.adapter_bonus
        s -= c.load_penalty * queue_depth(eng)
        mgr = eng.cachemgr
        if isinstance(mgr, PagedCacheManager) and mgr.reserved_debt > 0:
            s -= c.lent_penalty * (mgr.lent_blocks / mgr.reserved_debt)
        return s

    # -- placement -------------------------------------------------------
    def route(self, r: Request) -> int:
        """Engine id to run ``r`` on; deterministic given fleet state."""
        if self.cfg.policy == "round-robin":
            eid = self._rr % len(self.engines)
            self._rr += 1
            return eid
        if self.cfg.policy == "least-loaded":
            return min(range(len(self.engines)),
                       key=lambda i: (queue_depth(self.engines[i]), i))
        scores = [self.score(e, r) for e in self.engines]
        # ties (a cold fleet) go to the emptier replica, then the lowest id
        return max(range(len(self.engines)),
                   key=lambda i: (scores[i], -queue_depth(self.engines[i]),
                                  -i))

    def scores(self, r: Request) -> List[float]:
        """Every replica's score."""
        return [self.score(e, r) for e in self.engines]
