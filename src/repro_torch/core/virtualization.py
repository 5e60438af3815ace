"""Virtualized adapters: a shared base model, a slotted LoRA bank, unified
adapter paging and void/unvoid migration.

Port of ``repro.core.virtualization``:

* the **base model** is one set of parameter tensors shared by every
  virtual model (no extra weight memory);
* an **AdapterStore** owns the per-layer stacked LoRA bank (``n_slots``
  resident adapters), the name -> slot map and the per-slot scale.  Loading
  writes one slot in place; when every slot is taken, ``acquire`` of an
  evicted adapter LRU-evicts an idle one (not pinned, not retained) to host
  memory and reloads the requested one, counting the swap-in;
* a **VirtualModel** is a named view ``(base, store, name, mode)``; ``void``
  detaches its adapter to host memory (base excluded) and ``unvoid`` binds
  it into a store on a given device (the paper's migration).

Unified adapter paging (``attach_pager``): the store is bound to a
``PagedCacheManager`` and adapter weights page through its block pool.  An
adapter is then bank-materialized (a slot of the bank the SMLM/BGMV kernels
read), pool-resident (its byte image at its true rank in pool blocks on the
device; materializing it is a gather) or host-archived (the next ``acquire``
is a counted, clock-charged swap-in).  The byte image (``_flatten``) is the
bank slot's leaves viewed as bytes, per layer and target ``a[:, :rank]``
then ``b[:rank]``: as many bytes as the JAX package's image, in its own
order.  The archive is a host copy of it, written at ``load`` and kept
current lazily: a training update marks the adapter dirty (``mark_dirty``)
and the image is re-taken from the bank at the next sync point (bank
eviction or pool shed).  Bank slots are always written in place, so the
bank leaves the grad step and the optimizer hold keep their storage.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch

from repro_torch.core.flow import FlowConfig
from repro_torch.core.lora import LoRAConfig, init_lora_bank
from repro_torch.device import DeviceLike, resolve_device, resolve_dtype
from repro_torch.errors import ConfigInvariantError, MigrationInvariantError
from repro_torch.models.configs import ModelConfig
from repro_torch.models.model import unified_forward
from repro_torch.models.schema import lora_targets


@dataclasses.dataclass
class VoidedModel:
    """A voided virtual model: adapter weights detached to host tensors,
    ready for serialization or migration to another device.  The base
    model is not included."""
    name: str
    cfg_name: str
    adapter: Any                     # {"layers": [{t: {"a", "b"}}]} on cpu
    scale: float


def _host(x: torch.Tensor, pin: bool) -> torch.Tensor:
    """A host copy of ``x``, in pinned memory when ``pin`` (a store on the
    card: its swap-ins are then asynchronous copies)."""
    h = torch.empty(x.shape, dtype=x.dtype, pin_memory=pin)
    h.copy_(x)
    return h


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
        # per layer: a MoE layer has shared_w* where a dense one has w*
        self.layer_targets = lora_targets(cfg, lcfg.targets)
        n, r = lcfg.n_slots, lcfg.r
        self.bank = {"layers": [
            {name: {"a": torch.zeros((n, t.d_in, r), device=self.device,
                                     dtype=self.dtype),
                    "b": torch.zeros((n, r, t.d_out), device=self.device,
                                     dtype=self.dtype)}
             for name, t in lt.items()}
            for lt in self.layer_targets]}
        self.scale = torch.ones((n,), dtype=torch.float32, device=self.device)
        self._slots: Dict[str, int] = {}
        self._voided: Dict[str, VoidedModel] = {}   # evicted, host-resident
        self._ranks: Dict[str, int] = {}             # name -> true rank
        self._pinned: set = set()
        self._refs: Dict[str, int] = {}
        self._lru: Dict[str, int] = {}
        self._tick = 0
        self.evictions = 0
        self.reloads = 0
        # unified paging (attach_pager): host archive of byte images,
        # adapters whose bank slot is newer than the archive, the pager
        self._archive: Dict[str, tuple] = {}         # name -> (bytes, scale)
        self._dirty: set = set()
        self.pager = None                            # PagedCacheManager
        self.swap_ins = 0
        self.swap_in_bytes = 0
        self.resident_hits = 0       # acquires served without host traffic
        self.peak_coresident = 0     # max adapters simultaneously on device

    # -- slot management ---------------------------------------------------
    def slot_of(self, name: str) -> int:
        return self._slots[name]

    @property
    def resident(self) -> List[str]:
        return list(self._slots)

    @property
    def voided(self) -> List[str]:
        """Adapters whose only copy is host memory."""
        out = list(self._voided)
        if self.pager is not None:
            out += [n for n in self._archive
                    if n not in self._slots
                    and not self.pager.adapter_resident(n)]
        return out

    def _touch(self, name: str):
        self._tick += 1
        self._lru[name] = self._tick

    @property
    def _pin(self) -> bool:
        return self.device.type == "cuda"

    @property
    def _itemsize(self) -> int:
        return torch.empty((), dtype=self.dtype).element_size()

    def adapter_nbytes(self, name: Optional[str] = None,
                       rank: Optional[int] = None) -> int:
        """Bytes of an adapter at its true rank (what the pool stores and a
        swap-in moves)."""
        rk = (int(rank) if rank is not None
              else self._ranks.get(name, self.lcfg.r))
        return self._itemsize * sum(rk * (t.d_in + t.d_out)
                                    for lt in self.layer_targets
                                    for t in lt.values())

    # -- unified paging: byte images + pager binding ------------------------
    def _flatten(self, slot: int, rank: int) -> torch.Tensor:
        """The byte image of bank slot ``slot`` at its true rank, a flat
        uint8 tensor on the store's device: per layer and target,
        ``a[:, :rank]`` then ``b[:rank]``.  Columns beyond the rank are
        dropped (``_write_image`` zero-fills them)."""
        parts = []
        for layer, lt in zip(self.bank["layers"], self.layer_targets):
            for t in lt:
                a, b = layer[t]["a"][slot], layer[t]["b"][slot]
                parts.append(a[:, :rank].contiguous().view(torch.uint8)
                             .reshape(-1))
                parts.append(b[:rank].contiguous().view(torch.uint8)
                             .reshape(-1))
        return torch.cat(parts)

    def _write_image(self, slot: int, image: torch.Tensor, rank: int):
        """In place: bank slot ``slot`` gets the byte image (the inverse of
        ``_flatten``), columns beyond ``rank`` zero."""
        flat = image.to(self.device, non_blocking=True)
        if flat.numel() != self.adapter_nbytes(rank=rank):
            raise ValueError("adapter byte image does not match the LoRA "
                             "target schema")
        it, off = self._itemsize, 0
        with torch.no_grad():
            for layer, lt in zip(self.bank["layers"], self.layer_targets):
                for name, t in lt.items():
                    da, db = layer[name]["a"][slot], layer[name]["b"][slot]
                    na, nb = t.d_in * rank * it, rank * t.d_out * it
                    da.zero_()
                    db.zero_()
                    da[:, :rank] = flat[off:off + na].view(
                        self.dtype).view(t.d_in, rank)
                    off += na
                    db[:rank] = flat[off:off + nb].view(
                        self.dtype).view(rank, t.d_out)
                    off += nb

    def attach_pager(self, pager):
        """Bind to a ``PagedCacheManager``: from here on adapter weights
        page through its block pool.  Loaded adapters are archived and
        preloaded into the pool where free capacity allows (no shedding);
        evicted ones move their host copies into the archive.  Existing
        pins and retains are forwarded to the pool."""
        if self.pager is not None:
            raise RuntimeError("a pager is already attached to this store")
        self.pager = pager
        pager.on_adapter_shed = self._on_pool_shed
        pager.adapter_redundant_fn = (
            lambda n: n in self._slots and n not in self._dirty)
        for n in self._pinned:
            # reprolint: ownership-transfer — mirrors an existing store
            # pin; unpin happens when that pin is dropped
            pager.adapter_pin(n)
        for n, c in self._refs.items():
            for _ in range(c):
                # reprolint: ownership-transfer — mirrors existing retains
                pager.adapter_pin(n)
        for n in list(self._slots):
            self._ranks.setdefault(n, self.lcfg.r)
            self._sync_from_bank(n)
            pager.adapter_admit(n, self._archive[n][0], shed=False)
        for n, v in list(self._voided.items()):
            rk = self._ranks.setdefault(n, self.lcfg.r)
            self._archive[n] = (self._image_of(v.adapter, rk), v.scale)
            del self._voided[n]
            pager.adapter_admit(n, self._archive[n][0], shed=False)
        self._note_coresident()

    def _image_of(self, adapter, rank: int) -> torch.Tensor:
        """Host byte image of an adapter given as tensors (the layout of
        ``_flatten``)."""
        parts = []
        for src, lt in zip(adapter["layers"], self.layer_targets):
            for t in lt:
                for k, cut in (("a", (slice(None), slice(0, rank))),
                               ("b", (slice(0, rank),))):
                    x = torch.as_tensor(src[t][k])[cut].to(
                        "cpu", self.dtype).contiguous()
                    parts.append(x.view(torch.uint8).reshape(-1))
        return _host(torch.cat(parts), self._pin)

    def _materialize(self, name: str, image: torch.Tensor, rank: int,
                     scale: float) -> int:
        """Write a byte image into a bank slot (LRU-evicting if full)."""
        slot = self._alloc(evict=True)
        self._write_image(slot, image, rank)
        with torch.no_grad():
            self.scale[slot] = scale
        self._slots[name] = slot
        self._touch(name)
        return slot

    def _sync_from_bank(self, name: str, refresh: bool = True):
        """Re-take ``name``'s byte image from its bank slot into the host
        archive (and rewrite its pool payload while pool-resident): the
        write-back that makes a trained adapter durable before its slot is
        reused."""
        slot = self._slots[name]
        flat = self._flatten(slot, self._ranks.get(name, self.lcfg.r))
        self._archive[name] = (_host(flat, self._pin),
                               float(self.scale[slot]))
        if (refresh and self.pager is not None
                and self.pager.adapter_resident(name)):
            self.pager.adapter_refresh(name, flat)
        self._dirty.discard(name)

    def _on_pool_shed(self, name: str):
        """Pool shed callback (before the victim's blocks are freed): keep
        the host archive current."""
        if name in self._dirty:
            if name in self._slots:
                self._sync_from_bank(name, refresh=False)
            else:
                self._dirty.discard(name)

    def mark_dirty(self, name: str):
        """A training step rewrote this adapter's bank slot: archive and
        pool copies are stale until the next sync point."""
        if self.pager is not None and name in self._archive:
            self._dirty.add(name)

    def is_resident(self, name: str) -> bool:
        """Usable without a host swap-in: bank-materialized or
        pool-resident (the scheduler's residency probe)."""
        if name in self._slots:
            return True
        if self.pager is not None:
            return self.pager.adapter_resident(name)
        return False

    @property
    def coresident(self) -> int:
        """Adapters on the device at once (bank + pool, deduplicated)."""
        names = set(self._slots)
        if self.pager is not None:
            names |= set(self.pager.adapter_tables)
        return len(names)

    def _note_coresident(self):
        self.peak_coresident = max(self.peak_coresident, self.coresident)

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
        """Retire the least-recently-used idle adapter's bank slot.  Under
        paging no ``VoidedModel`` is written: the archive (synced here if
        the victim is dirty) already holds it."""
        candidates = [n for n in self._slots
                      if n not in self._pinned and not self._refs.get(n, 0)]
        if not candidates:
            return None
        victim = min(candidates, key=lambda n: self._lru.get(n, 0))
        slot = self._slots[victim]
        if self.pager is not None:
            if victim in self._dirty:
                self._sync_from_bank(victim)
        else:
            self._voided[victim] = VoidedModel(
                name=victim, cfg_name=self.cfg.name,
                adapter=self.get_adapter(victim, device="cpu"),
                scale=float(self.scale[slot]))
        self.unload(victim)
        self.evictions += 1
        return slot

    def _write(self, slot: int, adapter, rank: int):
        """Write ``adapter`` into ``slot``, zeroing columns beyond
        ``rank`` (how a true-rank adapter is defined)."""
        for dst, src in zip(self.bank["layers"], adapter["layers"]):
            for name in dst:
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
        ``evict=True``, always under paging): no base-model copy.  ``rank``
        is its true rank (<= the bank rank): columns beyond it are zero, and
        under paging its pool and transfer footprint is proportional to
        it."""
        if name in self._slots:
            raise ValueError(f"adapter {name!r} already resident")
        rk = int(rank) if rank is not None else self.lcfg.r
        if not 1 <= rk <= self.lcfg.r:
            raise ValueError(f"rank {rk} outside [1, {self.lcfg.r}]")
        self._ranks[name] = rk
        if self.pager is not None:
            image = self._image_of(adapter, rk)
            self._archive[name] = (image, float(scale))
            self._dirty.discard(name)
            self.pager.adapter_admit(name, image)     # best effort
            slot = self._materialize(name, image, rk, scale)
            self._note_coresident()
            return slot
        slot = self._alloc(evict=evict)
        with torch.no_grad():
            self._write(slot, adapter, rk)
            self.scale[slot] = scale
        self._slots[name] = slot
        self._voided.pop(name, None)
        self._touch(name)
        self._note_coresident()
        return slot

    def load_random(self, name: str, generator: torch.Generator,
                    scale: float = 1.0, gaussian_b: bool = True,
                    evict: bool = False, rank: Optional[int] = None) -> int:
        """A random adapter from ``generator`` (on the store's device)."""
        one = init_lora_bank(self.layer_targets,
                             LoRAConfig(n_slots=1, r=self.lcfg.r,
                                        alpha=self.lcfg.alpha),
                             generator, self.device, self.dtype,
                             gaussian_b=gaussian_b)
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
        """Resolve an adapter to a bank slot, re-materializing it.  Under
        paging a bank hit or a pool gather costs no host traffic
        (``resident_hits``); a host-archived adapter is first swapped into
        the pool (counted) and then gathered.  Raises ``KeyError`` for an
        unknown adapter and ``RuntimeError`` when neither the bank nor the
        pool can take it this tick."""
        if name in self._slots:
            self._touch(name)
            self.resident_hits += 1
            return self._slots[name]
        if self.pager is not None and name in self._archive:
            image, scale = self._archive[name]
            if self.pager.adapter_resident(name):
                self.resident_hits += 1
            else:
                if not self.pager.adapter_admit(name, image):
                    raise RuntimeError(
                        f"no pool capacity to swap in adapter {name!r}")
                self.swap_ins += 1
                self.swap_in_bytes += int(image.numel())
            # gather from the pool, the production read path
            slot = self._materialize(name, self.pager.adapter_gather(name),
                                     self._ranks[name], scale)
            self.reloads += 1
            self._note_coresident()
            return slot
        if name in self._voided:
            v = self._voided[name]
            slot = self.load(name, v.adapter, v.scale, evict=True,
                             rank=self._ranks.get(name))
            self.reloads += 1
            self.swap_ins += 1
            self.swap_in_bytes += self.adapter_nbytes(name)
            return slot
        raise KeyError(f"unknown adapter {name!r}")

    def retain(self, name: str):
        """Mark the adapter as backing in-flight work (eviction-exempt;
        under paging its pool blocks are pinned too)."""
        self._refs[name] = self._refs.get(name, 0) + 1
        if self.pager is not None:
            self.pager.adapter_pin(name)

    def release(self, name: str):
        n = self._refs.get(name, 0) - 1
        if n <= 0:
            self._refs.pop(name, None)
        else:
            self._refs[name] = n
        if self.pager is not None:
            self.pager.adapter_unpin(name)

    def pin(self, name: str):
        """Exempt from eviction permanently."""
        if name not in self._pinned and self.pager is not None:
            self.pager.adapter_pin(name)
        self._pinned.add(name)

    def unpin(self, name: str):
        if name in self._pinned and self.pager is not None:
            self.pager.adapter_unpin(name)
        self._pinned.discard(name)

    def set_bank(self, bank):
        """Replace the bank wholesale (after an optimizer update)."""
        self.bank = bank

    def slot_mask(self, names: List[str]) -> torch.Tensor:
        """[n_slots] float32 on the store's device, 1 at the named
        adapters' slots."""
        m = torch.zeros((self.lcfg.n_slots,), dtype=torch.float32)
        for n in names:
            m[self._slots[n]] = 1.0
        return m.to(self.device)

    def get_adapter(self, name: str, device: DeviceLike = None):
        slot = self._slots[name]
        dev = self.device if device is None else torch.device(device)
        return {"layers": [{t: {"a": ab["a"][slot].to(dev, copy=True),
                                "b": ab["b"][slot].to(dev, copy=True)}
                            for t, ab in layer.items()}
                           for layer in self.bank["layers"]]}


class VirtualModel:
    """An isolated adapter view over a shared base model (one per tenant or
    fine-tuning job)."""

    def __init__(self, name: str, base_params, store: AdapterStore,
                 mode: str = "infer"):
        if mode not in ("infer", "train"):
            raise ConfigInvariantError(f"unknown VirtualModel mode {mode!r}")
        self.name, self.base, self.store, self.mode = (name, base_params,
                                                       store, mode)

    @property
    def slot(self) -> int:
        return self.store.slot_of(self.name)

    # -- migration (the paper's void / unvoid) ------------------------------
    def void(self) -> VoidedModel:
        return VoidedModel(name=self.name, cfg_name=self.store.cfg.name,
                           adapter=self.store.get_adapter(self.name,
                                                          device="cpu"),
                           scale=float(self.store.scale[self.slot]))

    @staticmethod
    def unvoid(voided: VoidedModel, base_params, store: AdapterStore,
               device: DeviceLike, mode: str = "infer") -> "VirtualModel":
        """Bind a voided adapter into ``store`` on ``device``, which must
        be the store's device."""
        if store.cfg.name != voided.cfg_name:
            raise MigrationInvariantError(
                f"config mismatch on migration: store={store.cfg.name!r} "
                f"voided={voided.cfg_name!r}")
        dev = torch.device(device)
        if dev.type != store.device.type:
            raise ValueError(f"unvoid onto {dev} but the store lives on "
                             f"{store.device}")
        adapter = {"layers": [
            {t: {k: torch.as_tensor(x).to(store.device)
                 for k, x in ab.items()} for t, ab in layer.items()}
            for layer in voided.adapter["layers"]]}
        store.load(voided.name, adapter, voided.scale)
        return VirtualModel(voided.name, base_params, store, mode)


class MixedLoraModel:
    """The executable unit of the unified flow: shared base + resident
    adapter bank (paper Section 3.3)."""

    def __init__(self, cfg: ModelConfig, base_params, store: AdapterStore):
        self.cfg, self.base, self.store = cfg, base_params, store

    def virtual(self, name: str, mode: str = "infer") -> VirtualModel:
        return VirtualModel(name, self.base, self.store, mode)

    def forward(self, batch, cache=None, **kw):
        """``unified_forward`` over the shared base and the store's bank;
        ``block_t`` defaults to the flow planner's tile, so ft and prefill
        rows are padded to a multiple of it (the engine's planner does
        that)."""
        kw.setdefault("block_t", FlowConfig().block_t)
        return unified_forward(self.cfg, self.base, batch, cache,
                               loras=self.store.bank,
                               lora_scale=self.store.scale, **kw)
