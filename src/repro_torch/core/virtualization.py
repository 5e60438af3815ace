"""Virtualized adapters: a shared base model plus a slotted LoRA bank.

Port of the static-bank part of ``repro.core.virtualization``:

* the **base model** is one set of parameter tensors shared by every
  virtual model (no extra weight memory);
* an **AdapterStore** owns the per-layer stacked LoRA bank (``n_slots``
  resident adapters), the name -> slot map and the per-slot scale.  Loading
  writes one slot in place; when every slot is taken, ``acquire`` of an
  evicted adapter LRU-evicts an idle one (not pinned, not retained) to host
  memory and reloads the requested one, counting the swap-in.

Void/unvoid migration and unified adapter paging (``attach_pager``) come in
later slices.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core.lora import LoRAConfig, init_lora_bank
from repro_torch.device import DeviceLike, resolve_device, resolve_dtype
from repro_torch.models.configs import ModelConfig
from repro_torch.models.schema import lora_targets


class AdapterStore:
    """Owns the stacked LoRA bank and the name -> slot mapping.

    ``bank = {"layers": [{target: {"a": [n, d_in, r], "b": [n, r, d_out]}}]}``
    lives on the store's device (``cuda`` unless ``device="cpu"``).  An
    adapter is ``{"layers": [{target: {"a": [d_in, r], "b": [r, d_out]}}]}``
    of tensors or numpy arrays."""

    def __init__(self, cfg: ModelConfig, lcfg: LoRAConfig,
                 device: DeviceLike = None, dtype=None):
        self.cfg, self.lcfg = cfg, lcfg
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(dtype, cfg.dtype)
        self.targets = lora_targets(cfg, lcfg.targets)
        n, r = lcfg.n_slots, lcfg.r
        self.bank = {"layers": [
            {name: {"a": torch.zeros((n, t.d_in, r), device=self.device,
                                     dtype=self.dtype),
                    "b": torch.zeros((n, r, t.d_out), device=self.device,
                                     dtype=self.dtype)}
             for name, t in self.targets.items()}
            for _ in range(cfg.n_layers)]}
        self.scale = torch.ones((n,), dtype=torch.float32, device=self.device)
        self._slots: Dict[str, int] = {}
        self._voided: Dict[str, tuple] = {}   # evicted: (host adapter, scale)
        self._ranks: Dict[str, int] = {}
        self._pinned: set = set()
        self._refs: Dict[str, int] = {}
        self._lru: Dict[str, int] = {}
        self._tick = 0
        self.evictions = 0
        self.reloads = 0
        self.swap_ins = 0
        self.swap_in_bytes = 0
        self.resident_hits = 0
        self.peak_coresident = 0

    # -- slot management ---------------------------------------------------
    def slot_of(self, name: str) -> int:
        return self._slots[name]

    def _touch(self, name: str):
        self._tick += 1
        self._lru[name] = self._tick

    def adapter_nbytes(self, name: str) -> int:
        """Bytes of an adapter at its true rank (what a swap-in moves)."""
        rk = self._ranks.get(name, self.lcfg.r)
        it = torch.empty((), dtype=self.dtype).element_size()
        per_layer = sum(rk * (t.d_in + t.d_out)
                        for t in self.targets.values())
        return self.cfg.n_layers * per_layer * it

    def _alloc(self, evict: bool = False) -> int:
        used = set(self._slots.values())
        for i in range(self.lcfg.n_slots):
            if i not in used:
                return i
        if evict:
            slot = self._evict_lru()
            if slot is not None:
                return slot
            raise RuntimeError("no free adapter slot and every resident "
                               "adapter is pinned or in use")
        raise RuntimeError("no free adapter slot; unload one first")

    def _evict_lru(self) -> Optional[int]:
        candidates = [n for n in self._slots
                      if n not in self._pinned and not self._refs.get(n, 0)]
        if not candidates:
            return None
        victim = min(candidates, key=lambda n: self._lru.get(n, 0))
        slot = self._slots[victim]
        host = self.get_adapter(victim, device="cpu")
        self._voided[victim] = (host, float(self.scale[slot]))
        self.unload(victim)
        self.evictions += 1
        return slot

    def _write(self, slot: int, adapter, rank: int):
        """Write ``adapter`` into ``slot``, zeroing columns beyond
        ``rank`` (how a true-rank adapter is defined)."""
        for dst, src in zip(self.bank["layers"], adapter["layers"]):
            for name in self.targets:
                a = torch.as_tensor(src[name]["a"])
                b = torch.as_tensor(src[name]["b"])
                da, db = dst[name]["a"][slot], dst[name]["b"][slot]
                da.zero_()
                db.zero_()
                da[:, :rank] = a[:, :rank].to(da.device, da.dtype)
                db[:rank] = b[:rank].to(db.device, db.dtype)

    def load(self, name: str, adapter, scale: float = 1.0,
             evict: bool = False, rank: Optional[int] = None) -> int:
        """Load an adapter into a free slot (LRU-evicting an idle one with
        ``evict=True``) — no base-model copy.  ``rank`` is its true rank
        (<= the bank rank): columns beyond it are zero."""
        if name in self._slots:
            raise ValueError(f"adapter {name!r} already resident")
        rk = int(rank) if rank is not None else self.lcfg.r
        if not 1 <= rk <= self.lcfg.r:
            raise ValueError(f"rank {rk} outside [1, {self.lcfg.r}]")
        self._ranks[name] = rk
        slot = self._alloc(evict=evict)
        with torch.no_grad():
            self._write(slot, adapter, rk)
            self.scale[slot] = scale
        self._slots[name] = slot
        self._voided.pop(name, None)
        self._touch(name)
        self.peak_coresident = max(self.peak_coresident, len(self._slots))
        return slot

    def load_random(self, name: str, generator: torch.Generator,
                    scale: float = 1.0, gaussian_b: bool = True,
                    evict: bool = False, rank: Optional[int] = None) -> int:
        """A random adapter from ``generator`` (on the store's device)."""
        one = init_lora_bank(self.targets,
                             LoRAConfig(n_slots=1, r=self.lcfg.r,
                                        alpha=self.lcfg.alpha),
                             self.cfg.n_layers, generator, self.device,
                             self.dtype, gaussian_b=gaussian_b)
        adapter = {"layers": [{t: {"a": ab["a"][0], "b": ab["b"][0]}
                               for t, ab in layer.items()}
                              for layer in one["layers"]]}
        return self.load(name, adapter, scale, evict=evict, rank=rank)

    def unload(self, name: str):
        slot = self._slots.pop(name)
        with torch.no_grad():
            for layer in self.bank["layers"]:
                for ab in layer.values():
                    ab["a"][slot].zero_()
                    ab["b"][slot].zero_()
        self._lru.pop(name, None)

    # -- eviction pool ------------------------------------------------------
    def acquire(self, name: str) -> int:
        """Resolve an adapter to a bank slot, reloading an evicted one
        (counted as a swap-in).  Raises ``KeyError`` for an unknown adapter
        and ``RuntimeError`` when no slot can be freed this tick."""
        if name in self._slots:
            self._touch(name)
            self.resident_hits += 1
            return self._slots[name]
        if name in self._voided:
            host, scale = self._voided[name]
            slot = self.load(name, host, scale, evict=True,
                             rank=self._ranks.get(name))
            self.reloads += 1
            self.swap_ins += 1
            self.swap_in_bytes += self.adapter_nbytes(name)
            return slot
        raise KeyError(f"unknown adapter {name!r}")

    def retain(self, name: str):
        """Mark the adapter as backing in-flight work (eviction-exempt)."""
        self._refs[name] = self._refs.get(name, 0) + 1

    def release(self, name: str):
        n = self._refs.get(name, 0) - 1
        if n <= 0:
            self._refs.pop(name, None)
        else:
            self._refs[name] = n

    def pin(self, name: str):
        """Exempt from eviction permanently."""
        self._pinned.add(name)

    def unpin(self, name: str):
        self._pinned.discard(name)

    def get_adapter(self, name: str, device: DeviceLike = None):
        slot = self._slots[name]
        dev = self.device if device is None else torch.device(device)
        return {"layers": [{t: {"a": ab["a"][slot].to(dev, copy=True),
                                "b": ab["b"][slot].to(dev, copy=True)}
                            for t, ab in layer.items()}
                           for layer in self.bank["layers"]]}


class MixedLoraModel:
    """The executable unit of the unified flow: shared base + resident
    adapter bank (paper Section 3.3)."""

    def __init__(self, cfg: ModelConfig, base_params, store: AdapterStore):
        self.cfg, self.base, self.store = cfg, base_params, store
