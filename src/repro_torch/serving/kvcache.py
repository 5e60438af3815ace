"""Engine-side KV cache management: dense rows and paged blocks.

Port of the part of ``repro.serving.kvcache`` that the engine uses.

**Dense** (``CacheManager``, ``EngineConfig(paged=False)``): the cache has
``capacity + pf_capacity`` rows of ``s_max`` key/value slots per layer
(``init_cache``); rows ``[0, capacity)`` are the persistent decode table,
and each step's prefill writes rows ``[Bd, Bd + Bp)`` (``Bd`` is that tick's
decode-bucket size).  After the step ``commit_prefill`` copies the freshly
prefilled rows into their decode slots.  Every resident request pays
``s_max`` slots whether it uses them or not.

**Paged** (``PagedCacheManager``, the default): attention K/V lives in a
flat pool of fixed-size blocks (``init_paged_cache``: ``[L, n_blocks,
block_size, ...]`` per named leaf on the engine's device); each request
owns a *block table*.  Admission is a block budget: a request is admitted
only when its projected life ``ceil(min(prompt + max_new, s_max) /
block_size)`` fits, but blocks are allocated on demand — the remainder is a
reservation (``reserved`` / ``reserved_debt``) that ``grow`` converts to real
blocks as decoding advances.  Block 0 is a reserved null block that absorbs
writes from padding rows.

Content-hash block dedup (``hash_dedup``): every full, immutable block is
content-addressed by a chained key ``sha1(adapter, parent_key, tokens)``.
``try_admit`` adopts the longest resident run of a prompt's key chain
(incref, no recompute); ``commit_prefill`` / ``commit_tokens`` publish each
newly filled full block (the index holds its own refcount, so a write into a
published block always copy-on-writes first); idle index-only blocks are
shed on demand, zero-hit first.

The device side is in place: the model writes K/V straight into the pool,
``update`` has nothing to swap in, and a copy-on-write fork copies one block
of the pool tensors.

The cache is a dict of named leaves (``models.model.cache_leaves``): the
block-addressed ``k`` and ``v`` [.., g, hd], or MLA's latent ``ckv`` [..,
c] and rope key ``kpe`` [.., dr], and the per-request state rows
(``STATE_KEYS``, ``capacity + pf_capacity`` rows each): a Mamba model's
``h`` / ``conv_x`` / ``conv_bc``, and a cross-attention model's projected
cross source ``xk`` / ``xv`` [F, g, hd].  Every place that touches a block
(copy, host layout, byte footprints) walks the block leaves
(``block_leaves``) in the JAX cache's key order and skips the state rows,
as the JAX manager does; ``commit_prefill`` copies the state rows from the
prefill bucket's rows into the decode slots.  A swap-out, restore, demote,
rehydrate or import moves blocks only: a restored cross request's suffix
prefill projects its ``aux_embed`` again and rewrites its row, as every
chunk of a chunked prefill does.  A model with no block leaf
(``mamba2-1.3b``) still keeps the block accounting, and its footprint is
``max(0, 1) = 1`` byte a block, as in the JAX package.

Over-admission (``over_admit > 1``): the gate charges only a ``1 /
over_admit`` slice of the outstanding reservation debt (``charged_debt``,
batch-class debt lent first, interactive never) and lends the rest; a
within-reservation ``grow`` that finds the pool dry then returns a short
capacity, the signal the engine answers with preemption.

The host tier (``host_blocks > 0``, ``HostBlockPool``): a preemption victim's
blocks are gathered into pinned host memory (``swap_out``) and written back
into its fresh table at re-admission (``restore_swap``), and shed index
blocks are demoted to host under their content key and rehydrated by a
later admission that walks the key chain.  ``host_quant`` stores them int8
(``models.quant``).  Byte accounting uses the static per-block footprints
(``adapter_block_bytes``, ``host_block_bytes``), never a tensor's size, so
the decisions replay as the JAX package's do.

Unified adapter paging: the same allocator backs a second block class,
adapter weights.  ``AdapterStore.attach_pager`` flattens each adapter at its
true rank into a byte payload that ``adapter_admit`` scatters into an
adapter pool ``[n_blocks, adapter_block_bytes]`` uint8 on the engine's
device (two same-shaped pools under one allocator, as in the JAX package).
Unpinned adapters are shed cold-LRU under pressure, redundant copies first.

The fleet (``repro_torch.fleet``): ``on_publish`` / ``on_depublish`` are
told of every change to the local index (publication, rehydration, import;
de-publication before its decref), which is what keeps a ``FleetIndex``
exact, and ``import_block`` copies one published block from a sibling
manager's pool into this one, on the card, and publishes it here.
"""
from __future__ import annotations

import hashlib
import math
from collections import OrderedDict, deque
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.errors import ConfigInvariantError, InvariantError
from repro_torch.models.configs import ModelConfig
from repro_torch.models.model import STATE_KEYS, init_cache, \
    init_paged_cache
from repro_torch.models.quant import dequant_leaf, quantize_leaf
from repro_torch.serving.clock import CostModel
from repro_torch.serving.request import priority_rank


class KVAccountingError(InvariantError):
    """A block-accounting invariant was violated: refcount misuse, or a
    within-reservation ``grow`` finding an empty pool under the conservative
    gate (which guarantees ``n_free >= debt``)."""


class OutOfBlocksError(RuntimeError):
    """The pool could not supply a block for a mandatory write (a
    copy-on-write fork).  Under ``over_admit > 1`` it is the growth-failure
    signal the engine answers with preemption."""


def swap_beats_recompute(stored_bytes: int, recompute_tokens: int,
                         cost: CostModel) -> bool:
    """The tiered-memory decision rule: a D2H + H2D round trip of the
    stored payload against suffix-prefill recompute of the tokens no other
    holder keeps on the device.  Strict ``<``: at a tie recompute wins."""
    transfer = stored_bytes * (cost.d2h_per_byte + cost.h2d_per_byte)
    return transfer < recompute_tokens * cost.prefill_per_tok


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


class HostBlockPool:
    """Host-RAM tier behind the device block pool.

    One byte budget (``capacity_bytes``: N device blocks' worth of raw K/V,
    as the engine sizes it), two entry kinds:

    * **swap sets**: a preemption victim's gathered blocks, pinned until the
      victim is re-admitted (restored) or dropped.  Working state, so
      ``pristine`` requires none outstanding;
    * **demoted blocks**: single index-shed blocks under their content key;
      an LRU cache, never pinned.

    Entry sizes are the manager's static per-block footprint, not the
    payload's ``nbytes``.  The payload lives in the manager's host arena;
    ``on_release`` (set by the manager) is told when the pool drops an
    entry itself (LRU eviction, ``drop_demoted``, ``flush_demoted``), so
    the entry's arena units can be reused.  An entry the pool hands back
    (``pop_swap``, ``pop_demoted``) is the caller's to release."""

    def __init__(self, capacity_bytes: int, quant: bool = False):
        if capacity_bytes <= 0:
            raise ConfigInvariantError(
                "host block pool needs a positive byte budget")
        self.capacity_bytes = int(capacity_bytes)
        self.quant = bool(quant)
        self._swap_sets: Dict[int, dict] = {}
        self._demoted: "OrderedDict[str, dict]" = OrderedDict()
        self._next_sid = 0
        self.used_bytes = 0
        self.peak_used_bytes = 0
        self.evictions = 0            # demoted entries LRU-dropped for space
        self.on_release: Optional[Callable[[dict], None]] = None

    def _release(self, entry: dict):
        if self.on_release is not None:
            self.on_release(entry)

    @property
    def n_swap_sets(self) -> int:
        return len(self._swap_sets)

    @property
    def n_demoted(self) -> int:
        return len(self._demoted)

    @property
    def free_bytes(self) -> int:
        return self.capacity_bytes - self.used_bytes

    def demoted_keys(self):
        return set(self._demoted)

    def _evict_for(self, nbytes: int) -> bool:
        """LRU-drop demoted entries until ``nbytes`` fit; swap sets are
        never touched.  False when even a full flush cannot fit them."""
        if nbytes > self.capacity_bytes:
            return False
        while (self.used_bytes + nbytes > self.capacity_bytes
               and self._demoted):
            _, old = self._demoted.popitem(last=False)
            self.used_bytes -= old["bytes"]
            self.evictions += 1
            self._release(old)
        return self.used_bytes + nbytes <= self.capacity_bytes

    def _charge(self, nbytes: int):
        self.used_bytes += nbytes
        self.peak_used_bytes = max(self.peak_used_bytes, self.used_bytes)

    def put_swap(self, entry: dict) -> Optional[int]:
        if not self._evict_for(entry["bytes"]):
            return None
        sid = self._next_sid
        self._next_sid += 1
        self._swap_sets[sid] = entry
        self._charge(entry["bytes"])
        return sid

    def pop_swap(self, sid: int, missing_ok: bool = False) -> Optional[dict]:
        entry = self._swap_sets.pop(sid, None)
        if entry is None:
            if missing_ok:
                return None
            raise KVAccountingError(f"unknown swap set {sid}")
        self.used_bytes -= entry["bytes"]
        return entry

    def put_demoted(self, key: str, entry: dict) -> bool:
        if key in self._demoted:      # refresh: same content by construction
            self._demoted.move_to_end(key)
            return True
        if not self._evict_for(entry["bytes"]):
            return False
        self._demoted[key] = entry
        self._charge(entry["bytes"])
        return True

    def has_demoted(self, key: str) -> bool:
        return key in self._demoted

    def pop_demoted(self, key: str) -> Optional[dict]:
        entry = self._demoted.pop(key, None)
        if entry is not None:
            self.used_bytes -= entry["bytes"]
        return entry

    def drop_demoted(self, key: str) -> bool:
        """Forget a demoted entry (its key became device-resident again)."""
        entry = self.pop_demoted(key)
        if entry is not None:
            self._release(entry)
        return entry is not None

    def flush_demoted(self) -> int:
        """Drop every demoted entry (swap sets stay: waiting requests own
        them).  Returns entries dropped."""
        n = len(self._demoted)
        for e in self._demoted.values():
            self.used_bytes -= e["bytes"]
            self._release(e)
        self._demoted.clear()
        return n


def projected_blocks(prompt_len: int, max_new: int, block_size: int,
                     s_max: int) -> int:
    """Blocks a request reserves on admission: its whole projected life,
    clipped to the context limit (shared by the scheduler's gate and the
    manager's reservation)."""
    tokens = min(prompt_len + max_new, s_max)
    return -(-tokens // block_size)


def block_key(adapter: str, parent: str, tokens: np.ndarray) -> str:
    """Content-hash identity of one full KV block: the adapter, the parent
    block's key (pins the whole left context) and the block's tokens."""
    h = hashlib.sha1()
    h.update(adapter.encode())
    h.update(b"\x00")
    h.update(parent.encode())
    h.update(b"\x00")
    h.update(np.ascontiguousarray(np.asarray(tokens, np.int64)).tobytes())
    return h.hexdigest()


def prompt_chain_keys(prompt: np.ndarray, adapter: str,
                      block_size: int) -> List[str]:
    """A prompt's block-key chain: one chained hash per leading full block,
    capped so at least one prompt token is always left uncached (suffix
    prefill needs a live query for the first-token logits)."""
    p = np.asarray(prompt)
    keys: List[str] = []
    parent = ""
    for i in range(max(len(p) - 1, 0) // block_size):
        parent = block_key(adapter, parent,
                           p[i * block_size:(i + 1) * block_size])
        keys.append(parent)
    return keys


def request_chain_keys(r, block_size: int) -> List[str]:
    """Per-request memoized chain keys, keyed by (prompt length, block
    size) — the prompt only changes when a preemption rolls output tokens
    into it."""
    memo = getattr(r, "_hash_keys", None)
    tag = (r.prompt_len, block_size)
    if memo is None or memo[0] != tag:
        memo = (tag, prompt_chain_keys(r.prompt, r.adapter, block_size))
        r._hash_keys = memo
    return memo[1]


class CacheManager:
    """Dense slot-per-request cache (the equivalence baseline of the paged
    path)."""

    def __init__(self, cfg: ModelConfig, capacity: int, pf_capacity: int,
                 s_max: int, *, device: torch.device, dtype: torch.dtype):
        self.cfg = cfg
        self.capacity = capacity          # decode-table rows
        self.pf_capacity = pf_capacity    # scratch rows for prefill buckets
        self.s_max = s_max
        self.cache = init_cache(cfg, capacity + pf_capacity, s_max, device,
                                dtype)
        self._free: Deque[int] = deque(range(capacity))
        self.lens = np.zeros((capacity,), np.int64)   # absolute positions

    # -- slot lifecycle ------------------------------------------------------
    def alloc(self) -> Optional[int]:
        return self._free.popleft() if self._free else None

    def free(self, slot: int):
        self.lens[slot] = 0
        self._free.append(slot)

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def pristine(self) -> bool:
        """Post-drain invariant: every slot is free with length 0."""
        return self.n_free == self.capacity and not self.lens.any()

    def truncate(self, slot: int, new_len: int):
        """Roll the sequence back.  Dense rows are position-indexed and
        masked by position, so stale K/V beyond ``new_len`` is invisible:
        only the length moves."""
        self.lens[slot] = new_len

    def commit_tokens(self, slot: int, toks: Sequence[int]):
        """Advance the committed length past freshly written decode
        positions (no block identity to publish)."""
        self.lens[slot] += len(toks)

    # -- step plumbing -------------------------------------------------------
    def step_cache(self):
        return self.cache

    def update(self, new_cache):
        """The model wrote the rows in place (``new_cache`` is
        ``self.cache``)."""
        self.cache = new_cache

    def commit_prefill(self, assignments: List[Tuple[int, int]],
                       lengths: List[int], src_base: Optional[int] = None):
        """assignments: (prefill row within the bucket, decode slot).
        ``src_base`` is the decode-bucket size of the step that produced the
        prefill rows (the model writes them at ``[Bd, Bd + Bp)``); it
        defaults to ``capacity``.  On a prefill-only tick the sources are
        rows ``0 .. n-1`` and may overlap the destination slots: every
        source row is gathered before any destination row is written."""
        if not assignments:
            return
        base = self.capacity if src_base is None else src_base
        dev = next(iter(self.cache.values())).device
        src = torch.tensor([base + i for i, _ in assignments], device=dev)
        dst = torch.tensor([s for _, s in assignments], device=dev)
        for rows in self.cache.values():
            rows[:, dst] = rows[:, src]       # the gather copies first
        for (_, slot), ln in zip(assignments, lengths):
            self.lens[slot] = ln


class BlockAllocator:
    """Fixed-size KV-block free list with refcounts.  Block 0 is the null
    block (never allocated): padding rows write there harmlessly."""

    def __init__(self, n_blocks: int):
        if n_blocks < 2:
            raise ConfigInvariantError(
                "need at least one usable block beyond null")
        self.n_blocks = n_blocks
        self._free: Deque[int] = deque(range(1, n_blocks))
        self.ref = np.zeros((n_blocks,), np.int64)
        self.ref[0] = 1                   # null block is permanently held
        self.peak_used = 0

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def usable(self) -> int:
        return self.n_blocks - 1

    @property
    def n_used(self) -> int:
        return self.usable - self.n_free

    def can_alloc(self, n: int) -> bool:
        return n <= self.n_free

    def alloc(self) -> Optional[int]:
        if not self._free:
            return None
        bid = self._free.popleft()
        self.ref[bid] = 1
        self.peak_used = max(self.peak_used, self.n_used)
        return bid

    def alloc_many(self, n: int) -> Optional[List[int]]:
        if not self.can_alloc(n):
            return None
        return [self.alloc() for _ in range(n)]

    def incref(self, bid: int):
        if bid == 0 or self.ref[bid] <= 0:
            raise KVAccountingError(f"incref of dead block {bid}")
        self.ref[bid] += 1

    def decref(self, bid: int):
        if bid == 0 or self.ref[bid] <= 0:
            raise KVAccountingError(f"decref of dead block {bid}")
        self.ref[bid] -= 1
        if self.ref[bid] == 0:
            self._free.append(bid)

    def is_shared(self, bid: int) -> bool:
        return self.ref[bid] > 1




class PagedCacheManager:
    """Block-table paged KV cache with the content-hash dedup index, the
    lending gate, the host tier and the adapter block class."""

    def __init__(self, cfg: ModelConfig, capacity: int, pf_capacity: int,
                 s_max: int, *, device: torch.device, dtype: torch.dtype,
                 block_size: int = 32, n_blocks: int = 0,
                 over_admit: float = 1.0, hash_dedup: bool = True,
                 host_blocks: int = 0, host_quant: bool = False,
                 cost: Optional[CostModel] = None):
        if cfg.sliding_window > 0:
            raise ValueError("paged cache does not support sliding windows")
        if over_admit < 1.0:
            raise ValueError("over_admit is a lending factor >= 1.0")
        self.cfg = cfg
        self.over_admit = float(over_admit)
        self.hash_dedup = bool(hash_dedup)
        self.lent_blocks_peak = 0
        self.hash_hits = 0                # blocks adopted via the index
        self.remote_imports = 0           # blocks fetched from sibling pools
        # fleet wiring: a FleetIndex is told of every local index change,
        # so its key -> (engine, block) map is exactly as fresh as the
        # local index (retraction fires from _depublish, the one local
        # removal path)
        self.on_publish: Optional[Callable[[str, int], None]] = None
        self.on_depublish: Optional[Callable[[str, int], None]] = None
        self.capacity = capacity
        self.pf_capacity = pf_capacity
        self.s_max = s_max
        self.block_size = block_size
        self.nbt = -(-s_max // block_size)          # table width (blocks/req)
        if n_blocks <= 0:
            # never more constrained than the dense layout by default
            n_blocks = 1 + capacity * self.nbt
        self.allocator = BlockAllocator(n_blocks)
        self.cache = init_paged_cache(cfg, n_blocks, block_size, device,
                                      dtype, n_rows=capacity + pf_capacity)
        self.device = next(iter(self.cache.values())).device
        self._free_slots: Deque[int] = deque(range(capacity))
        self.lens = np.zeros((capacity,), np.int64)
        self.tables: Dict[int, List[int]] = {}      # slot -> block ids
        self.shared_count: Dict[int, int] = {}      # leading adopted blocks
        self.reserved: Dict[int, int] = {}          # slot -> reserved blocks
        self._debt = 0                              # sum of unfilled reserves
        # content-hash index: chained key -> block id, publication-ordered
        # for LRU; the index holds its own ref on every published block
        self._index: "OrderedDict[str, int]" = OrderedDict()
        self._hashed: Dict[int, str] = {}           # block id -> key
        self._hits: Dict[str, int] = {}             # key -> adoption count
        # per-slot dedup state: token record (s_max buffer, valid through
        # _seq_len), key chain of its leading full blocks, adapter, and
        # whether the slot may share at all
        self._seqs: Dict[int, np.ndarray] = {}
        self._seq_len: Dict[int, int] = {}
        self._chains: Dict[int, List[str]] = {}
        self._adapters: Dict[int, str] = {}
        self._share: Dict[int, bool] = {}
        # static per-block footprints: one allocator unit is one HBM unit
        # for both block classes (raw bytes of a block over every leaf and
        # layer), and the int8 host footprint is a 1-byte payload plus an
        # f32 scale per quantize_leaf group (axis -2: the g KV heads of
        # k/v, the block's positions of ckv/kpe), the JAX formula; state
        # rows are not blocks
        bb = qb = 0
        for pool in self.block_leaves.values():
            e = pool.numel() // pool.shape[1]         # elements per block
            bb += e * pool.element_size()
            qb += e + (e // pool.shape[-2]) * 4
        self.adapter_block_bytes = max(int(bb), 1)
        self.cost = cost                  # CostModel; None = transfers free
        self.host_quant = bool(host_quant)
        self.host_block_bytes = (max(int(qb), 1) if host_quant
                                 else self.adapter_block_bytes)
        self.host_pool: Optional[HostBlockPool] = (
            HostBlockPool(host_blocks * self.adapter_block_bytes,
                          quant=host_quant)
            if host_blocks > 0 else None)
        # the host tier's storage: one arena of host_block_bytes units,
        # pinned when the pool is on the card and allocated once, so a swap
        # is copies into memory that is already pinned; a stored block
        # takes one unit (the byte budget never admits more units than
        # the arena has)
        self._arena: Optional[torch.Tensor] = None
        self._free_units: Deque[int] = deque()
        if self.host_pool is not None:
            self.host_pool.on_release = self._release_units
            n_units = self.host_pool.capacity_bytes // self.host_block_bytes
            self._arena = torch.empty(
                (n_units, self.host_block_bytes), dtype=torch.uint8,
                pin_memory=self.device.type == "cuda")
            self._free_units.extend(range(n_units))
        self.kv_swap_outs = 0             # preemption swap-outs (D2H)
        self.kv_swap_out_bytes = 0
        self.kv_restores = 0              # re-admission restores (H2D)
        self.kv_restore_bytes = 0
        self.kv_swap_drops = 0            # swap sets released unrestored
        self.kv_demotions = 0             # index sheds captured to host
        self.kv_demote_bytes = 0
        self.kv_rehydrations = 0          # demoted blocks re-published
        self.kv_rehydrate_bytes = 0
        # per-priority-rank reservation debt (interactive/standard/batch):
        # the lending order of charged_debt; sums to self._debt
        self._class_debt = [0, 0, 0]
        self._slot_rank: Dict[int, int] = {}
        self._adapter_pool: Optional[torch.Tensor] = None  # [n_blocks, abb]
        self.adapter_tables: Dict[str, List[int]] = {}
        self._adapter_bytes: Dict[str, int] = {}    # true payload bytes
        self._adapter_pins: Dict[str, int] = {}     # name -> pin count
        self._adapter_lru: Dict[str, int] = {}      # name -> last touch
        self._adapter_tick = 0
        self.adapter_swap_ins = 0                   # pool admits
        self.adapter_swap_in_bytes = 0
        self.adapter_sheds = 0
        # set by AdapterStore.attach_pager: told before a shed victim's
        # blocks are freed, and asked which pool copies are redundant
        self.on_adapter_shed: Optional[Callable[[str], None]] = None
        self.adapter_redundant_fn: Optional[Callable[[str], bool]] = None

    @property
    def block_leaves(self) -> Dict[str, torch.Tensor]:
        """The block-addressed cache leaves ``[L_kind, n_blocks, bs,
        ...]``, in order (the state rows left out)."""
        return {k: v for k, v in self.cache.items() if k not in STATE_KEYS}

    # -- budget --------------------------------------------------------------
    @property
    def n_free(self) -> int:
        return len(self._free_slots)

    @property
    def charged_debt(self) -> int:
        """Reservation debt the gate charges: all of it at ``over_admit ==
        1``, else all but a lent ``debt - ceil(debt / over_admit)`` taken
        from batch-class debt first, then standard; interactive debt is
        never lent."""
        lend = self._debt - math.ceil(self._debt / self.over_admit)
        lend_batch = min(lend, self._class_debt[2])
        lend_std = min(lend - lend_batch, self._class_debt[1])
        return self._debt - lend_batch - lend_std

    def _debt_add(self, slot: int, delta: int):
        """The one mutation path of the reservation debt: keeps the
        per-class split in step with the total."""
        self._debt += delta
        self._class_debt[self._slot_rank.get(slot, 1)] += delta

    @property
    def free_blocks(self) -> int:
        """Blocks the admission gate may spend: the free list minus the
        charged debt (negative while lent reservations are claimed)."""
        return self.allocator.n_free - self.charged_debt

    @property
    def reserved_debt(self) -> int:
        return self._debt

    @property
    def lent_blocks(self) -> int:
        """Reservation debt not backed by the free list: capacity actually
        lent out (0 under the conservative gate)."""
        return max(self._debt - self.allocator.n_free, 0)

    def _touch_lent(self):
        self.lent_blocks_peak = max(self.lent_blocks_peak, self.lent_blocks)

    @property
    def total_blocks(self) -> int:
        return self.allocator.usable

    def projected_blocks(self, prompt_len: int, max_new: int) -> int:
        return projected_blocks(prompt_len, max_new, self.block_size,
                                self.s_max)

    def _debt_of(self, slot: int) -> int:
        return max(self.reserved.get(slot, 0) - len(self.tables[slot]), 0)

    @property
    def reclaimable_adapter_blocks(self) -> int:
        """Blocks of unpinned resident adapters: sheddable on demand."""
        return sum(len(t) for n, t in self.adapter_tables.items()
                   if not self._adapter_pins.get(n, 0))

    @property
    def reclaimable_blocks(self) -> int:
        """Blocks held only by the hash index (ref == 1) plus unpinned
        adapters' blocks: pure cache, so the admission gate counts them
        available."""
        n = self.reclaimable_adapter_blocks
        if not self._hashed:
            return n
        bids = np.fromiter(self._hashed, np.int64, len(self._hashed))
        return n + int(np.count_nonzero(self.allocator.ref[bids] == 1))

    @property
    def hash_blocks_resident(self) -> int:
        return len(self._index)

    @property
    def pristine(self) -> bool:
        """Post-drain invariant: no live tables, no reservation debt, every
        non-free block held only by the index or an unpinned adapter, and
        no swap set outstanding."""
        return (not self.tables and self._debt == 0
                and self.allocator.n_free + self.reclaimable_blocks
                == self.allocator.usable
                and (self.host_pool is None
                     or self.host_pool.n_swap_sets == 0))

    # -- content-hash chain --------------------------------------------------
    def chain_keys(self, prompt: np.ndarray, adapter: str = "") -> List[str]:
        return prompt_chain_keys(prompt, adapter, self.block_size)

    def _resident_run(self, keys: Sequence[str]) -> List[int]:
        """Longest leading run of index-resident blocks for a key chain."""
        bids: List[int] = []
        for k in keys:
            bid = self._index.get(k)
            if bid is None:
                break
            bids.append(bid)
        return bids

    def probe(self, prompt: np.ndarray, adapter: str = "",
              keys: Optional[Sequence[str]] = None) -> int:
        """Prompt tokens the index would serve from resident K/V (pure
        preview: no incref, no LRU touch)."""
        if not self.hash_dedup:
            return 0
        if keys is None:
            keys = self.chain_keys(prompt, adapter)
        return len(self._resident_run(keys)) * self.block_size

    def fresh_need(self, prompt_len: int, max_new: int,
                   prompt: Optional[np.ndarray] = None, adapter: str = "",
                   headroom: int = 0, keys: Optional[Sequence[str]] = None,
                   shareable: bool = True) -> int:
        """The request's charge against the gate's ``free + reclaimable``
        budget: adoptable blocks with ref >= 2 cost nothing; index-only
        (ref == 1) adoptable blocks were counted reclaimable, so they are
        still charged."""
        held_elsewhere = 0
        if self.hash_dedup and shareable and prompt is not None:
            if keys is None:
                keys = self.chain_keys(prompt, adapter)
            held_elsewhere = sum(1 for b in self._resident_run(keys)
                                 if self.allocator.ref[b] >= 2)
        return (self.projected_blocks(prompt_len, max_new + headroom)
                - held_elsewhere)

    # -- admission -----------------------------------------------------------
    def try_admit(self, prompt: np.ndarray, max_new: int, adapter: str = "",
                  headroom: int = 0, shareable: bool = True,
                  keys: Optional[Sequence[str]] = None,
                  priority: str = "standard"
                  ) -> Optional[Tuple[int, int]]:
        """Reserve a slot and the request's projected block budget, adopting
        the longest resident run of its key chain (extended by rehydrating
        demoted host blocks), but allocate only the blocks the prompt needs
        now.  ``priority`` orders lending.  Returns ``(slot, reused prefix
        tokens)`` or None when slots or spendable blocks are exhausted."""
        if not self._free_slots:
            return None
        need = self.projected_blocks(len(prompt), max_new + headroom)
        share = bool(self.hash_dedup and shareable)
        adopt_keys: List[str] = []
        shared: List[int] = []
        if share:
            if keys is None:
                keys = self.chain_keys(prompt, adapter)
            shared = self._resident_run(keys)
            if self.host_pool is not None:
                # two-tier walk: extend the run by rehydrating consecutive
                # demoted host blocks
                while len(shared) < len(keys):
                    bid = self._rehydrate(keys[len(shared)],
                                          protect=frozenset(shared))
                    if bid is None:
                        break
                    shared.append(bid)
            adopt_keys = list(keys[:len(shared)])
        now_need = min(self.projected_blocks(len(prompt), 0), need)
        fresh_need = need - len(shared)
        fresh_now = max(now_need - len(shared), 0)
        if fresh_need > self.free_blocks:
            # shed idle cache to make room (index blocks, then unpinned
            # adapters), never the run this admission is about to adopt
            protect = frozenset(shared)
            while (fresh_need > self.free_blocks
                   and self._shed_any(protect_blocks=protect)):
                pass
            if fresh_need > self.free_blocks:
                return None
        for k, bid in zip(adopt_keys, shared):
            # reprolint: ownership-transfer — the adopted ref is owned by
            # this slot's table; ``free`` decrefs it
            self.allocator.incref(bid)
            self._hits[k] = self._hits.get(k, 0) + 1
            self._index.move_to_end(k)                # LRU touch
            self.hash_hits += 1
        fresh = self.allocator.alloc_many(fresh_now)
        if fresh is None:
            raise KVAccountingError(
                "admission gate passed but the pool cannot back the prompt")
        slot = self._free_slots.popleft()
        self.tables[slot] = shared + fresh
        self.shared_count[slot] = len(shared)
        self.reserved[slot] = max(need, len(self.tables[slot]))
        self._slot_rank[slot] = priority_rank(priority)
        self._debt_add(slot, self._debt_of(slot))
        self.lens[slot] = 0
        n_rec = min(len(prompt), self.s_max)
        buf = np.zeros((self.s_max,), np.int64)
        buf[:n_rec] = np.asarray(prompt[:n_rec], np.int64)
        self._seqs[slot] = buf
        self._seq_len[slot] = n_rec
        self._chains[slot] = adopt_keys
        self._adapters[slot] = adapter
        self._share[slot] = share
        self._touch_lent()
        return slot, len(shared) * self.block_size

    def free(self, slot: int):
        self._debt_add(slot, -self._debt_of(slot))
        self._slot_rank.pop(slot, None)
        self.reserved.pop(slot, None)
        for bid in self.tables.pop(slot, []):
            self.allocator.decref(bid)
        self.shared_count.pop(slot, None)
        self._seqs.pop(slot, None)
        self._seq_len.pop(slot, None)
        self._chains.pop(slot, None)
        self._adapters.pop(slot, None)
        self._share.pop(slot, None)
        self.lens[slot] = 0
        self._free_slots.append(slot)

    # -- sequence growth -----------------------------------------------------
    def grow(self, slot: int, new_len: int) -> int:
        """Extend ``slot``'s table to cover ``new_len`` tokens.  Under the
        conservative gate growth within the reservation always succeeds (an
        empty pool there raises ``KVAccountingError``); under lending the
        earmarked block may be lent out, and the short return value is the
        failure signal the engine answers with preemption.  Growth beyond
        the reservation is best-effort.  Returns the token capacity now
        covered."""
        table = self.tables[slot]
        target = min(-(-new_len // self.block_size), self.nbt)
        while len(table) < target:
            within = len(table) < self.reserved.get(slot, 0)
            if not within and self.free_blocks <= 0:
                break                       # transient overshoot, pool dry
            d0 = self._debt_of(slot)
            bid = self.allocator.alloc()
            while bid is None and self._shed_any():
                bid = self.allocator.alloc()
            if bid is None:
                if within and self.over_admit <= 1.0:
                    raise KVAccountingError(
                        "reservation debt accounting violated: within-"
                        "reservation grow found an empty pool under the "
                        "conservative gate")
                break                       # lent out: the engine preempts
            table.append(bid)
            self._debt_add(slot, self._debt_of(slot) - d0)
        self._touch_lent()
        return min(len(table) * self.block_size, self.s_max)

    def truncate(self, slot: int, new_len: int):
        """Roll ``slot`` back to ``new_len`` tokens (speculation rollback):
        release table blocks past the new length, restoring the slot's
        reservation debt.  Shared (adopted/CoW/index-held) blocks are only
        dereferenced: another holder's refcount keeps them alive.  The slot's
        own dedup record is de-published: its committed tokens and key chain
        shrink with the length, so a re-fill with other content publishes
        fresh keys (index entries for the old content stay valid)."""
        new_len = max(int(new_len), 0)
        table = self.tables[slot]
        nb = -(-new_len // self.block_size)
        if nb < len(table):
            d0 = self._debt_of(slot)
            dropped = len(table) - nb
            freed = 0
            for bid in table[nb:]:
                self.allocator.decref(bid)
                if self.allocator.ref[bid] == 0:
                    freed += 1
            del table[nb:]
            self.shared_count[slot] = min(self.shared_count.get(slot, 0), nb)
            # a dropped block that other holders keep alive never re-enters
            # the free list, so the slot's re-grow claim on it is surrendered
            # with it: re-crediting the full drop would make the debt exceed
            # the blocks actually available
            self.reserved[slot] = max(
                self.reserved.get(slot, 0) - (dropped - freed), len(table))
            self._debt_add(slot, self._debt_of(slot) - d0)
        if slot in self._seqs:
            self._seq_len[slot] = min(self._seq_len[slot], new_len)
            del self._chains[slot][new_len // self.block_size:]
        self.lens[slot] = new_len

    def prepare_write(self, slot: int, start: int, n: int) -> int:
        """Make positions ``[start, start + n)`` writable: grow the table and
        copy-on-write every shared block in the range.  Returns how many of
        the ``n`` tokens can be written."""
        cap = self.grow(slot, start + n)
        end = min(start + n, cap)
        if end <= start:
            return 0
        for bi in range(start // self.block_size,
                        (end - 1) // self.block_size + 1):
            self.ensure_writable(slot, pos=bi * self.block_size)
        return end - start

    # -- content-hash publication --------------------------------------------
    def commit_tokens(self, slot: int, toks: Sequence[int]):
        """Record freshly committed decode input tokens and publish any
        block the advance fills."""
        sl = self._seq_len[slot]
        n = min(len(toks), self.s_max - sl)
        if n:
            self._seqs[slot][sl:sl + n] = np.asarray(toks[:n], np.int64)
            self._seq_len[slot] = sl + n
        self.lens[slot] = self._seq_len[slot]
        self._publish_upto(slot)

    def _publish_upto(self, slot: int):
        """Publish ``slot``'s newly filled full blocks into the index (the
        index increfs each, making its payload immutable: later writes
        copy-on-write).  A key already resident keeps the incumbent."""
        if not self._share.get(slot, False):
            return
        bs = self.block_size
        seq = self._seqs[slot]
        chain = self._chains[slot]
        table = self.tables[slot]
        adapter = self._adapters.get(slot, "")
        n_full = min(int(self.lens[slot]), self._seq_len[slot]) // bs
        n_full = min(n_full, len(table))
        while len(chain) < n_full:
            i = len(chain)
            parent = chain[-1] if chain else ""
            key = block_key(adapter, parent, seq[i * bs:(i + 1) * bs])
            chain.append(key)
            bid = table[i]
            if bid == 0 or key in self._index or bid in self._hashed:
                continue
            self._index[key] = bid
            self._hashed[bid] = key
            self._hits.setdefault(key, 0)
            # reprolint: ownership-transfer — the index owns this ref;
            # _depublish decrefs it
            self.allocator.incref(bid)
            if self.host_pool is not None:
                # two-tier disjointness: a key lives in one tier
                self.host_pool.drop_demoted(key)
            if self.on_publish is not None:
                self.on_publish(key, bid)

    def _depublish(self, key: str):
        bid = self._index.pop(key)
        del self._hashed[bid]
        self._hits.pop(key, None)
        if self.on_depublish is not None:
            self.on_depublish(key, bid)
        self.allocator.decref(bid)

    def _shed_one(self, protect: frozenset = frozenset()) -> bool:
        """Evict one index entry whose block only the index holds: zero-hit
        first (publication order), then the lowest adoption count.  Every
        scan halves every hit count after choosing (hit aging).  With a host
        tier the victim's payload is demoted to host first."""
        best = None
        for k, bid in self._index.items():
            if bid in protect or self.allocator.ref[bid] != 1:
                continue
            score = self._hits.get(k, 0)
            if best is None or score < best[0]:
                best = (score, k)
                if score == 0:
                    break
        for k in self._hits:
            self._hits[k] >>= 1
        if best is None:
            return False
        if self.host_pool is not None:
            self._demote(best[1])
        self._depublish(best[1])
        return True

    def flush_index(self) -> int:
        """Shed every reclaimable index entry.  Returns entries shed."""
        n = 0
        while self._shed_one():
            n += 1
        return n

    # -- adapter block class (unified paging) --------------------------------
    def adapter_blocks_of(self, nbytes: int) -> int:
        """Pool blocks a payload of ``nbytes`` occupies (at least 1)."""
        return max(-(-int(nbytes) // self.adapter_block_bytes), 1)

    def adapter_resident(self, name: str) -> bool:
        return name in self.adapter_tables

    @property
    def adapter_blocks_resident(self) -> int:
        return sum(len(t) for t in self.adapter_tables.values())

    def _adapter_touch(self, name: str):
        self._adapter_tick += 1
        self._adapter_lru[name] = self._adapter_tick

    def _adapter_write(self, bids: List[int], flat: torch.Tensor):
        """Scatter ``flat`` over the pool rows ``bids`` (zero tail)."""
        abb = self.adapter_block_bytes
        buf = torch.zeros((len(bids), abb), dtype=torch.uint8,
                          device=self.device)
        buf.view(-1)[:flat.numel()].copy_(flat, non_blocking=True)
        if self._adapter_pool is None:
            self._adapter_pool = torch.zeros(
                (self.allocator.n_blocks, abb), dtype=torch.uint8,
                device=self.device)
        self._adapter_pool.index_copy_(
            0, torch.tensor(bids, dtype=torch.long, device=self.device), buf)

    def adapter_admit(self, name: str, payload: torch.Tensor,
                      shed: bool = True) -> bool:
        """Admit an adapter's byte payload (uint8) into the shared pool (the
        swap-in): allocate ``adapter_blocks_of`` blocks from the free list
        KV admission spends, within the gate's spendable budget, shedding
        idle index blocks then colder unpinned adapters when short
        (``shed=False``: only genuinely free capacity).  Returns False when
        the pool cannot take it."""
        if name in self.adapter_tables:
            self._adapter_touch(name)
            return True
        flat = payload.reshape(-1)
        n = self.adapter_blocks_of(flat.numel())
        if shed:
            while (n > self.free_blocks
                   and self._shed_any(protect_adapters=frozenset((name,)))):
                pass
        if n > self.free_blocks:
            return False
        bids = self.allocator.alloc_many(n)
        if bids is None:                     # free_blocks <= n_free always
            raise KVAccountingError(
                "adapter admission gate passed but the pool cannot back it")
        self._adapter_write(bids, flat)
        self.adapter_tables[name] = bids
        self._adapter_bytes[name] = int(flat.numel())
        self._adapter_touch(name)
        self.adapter_swap_ins += 1
        self.adapter_swap_in_bytes += int(flat.numel())
        self._touch_lent()
        return True

    def adapter_gather(self, name: str) -> torch.Tensor:
        """A resident adapter's payload, gathered from its pool blocks: a
        flat uint8 tensor on the pool's device."""
        bids = self.adapter_tables[name]
        self._adapter_touch(name)
        rows = self._adapter_pool.index_select(
            0, torch.tensor(bids, dtype=torch.long, device=self.device))
        return rows.view(-1)[:self._adapter_bytes[name]]

    def adapter_refresh(self, name: str, payload: torch.Tensor):
        """Rewrite a resident adapter's payload in place (training
        write-back; the footprint cannot change).  Not a swap-in."""
        if name not in self.adapter_tables:
            return
        flat = payload.reshape(-1)
        bids = self.adapter_tables[name]
        if self.adapter_blocks_of(flat.numel()) != len(bids):
            raise KVAccountingError(
                f"adapter {name!r} refresh changed its block footprint")
        self._adapter_write(bids, flat)
        self._adapter_bytes[name] = int(flat.numel())
        self._adapter_touch(name)

    def adapter_free(self, name: str):
        """Drop an adapter's pool residency."""
        for bid in self.adapter_tables.pop(name, []):
            self.allocator.decref(bid)
        self._adapter_bytes.pop(name, None)
        self._adapter_lru.pop(name, None)

    def adapter_pin(self, name: str):
        """Pin an adapter against shedding while any scheduled row uses it
        (by name, so a later admit is born protected)."""
        self._adapter_pins[name] = self._adapter_pins.get(name, 0) + 1

    def adapter_unpin(self, name: str):
        n = self._adapter_pins.get(name, 0) - 1
        if n <= 0:
            self._adapter_pins.pop(name, None)
        else:
            self._adapter_pins[name] = n

    def _shed_adapter(self, protect: frozenset = frozenset()) -> bool:
        """Evict one unpinned adapter's pool blocks: redundant copies first
        (bank-materialized and clean), then the coldest.  ``on_adapter_shed``
        fires before the blocks are freed."""
        cands = [n for n in self.adapter_tables
                 if n not in protect and not self._adapter_pins.get(n, 0)]
        if not cands:
            return False
        redundant = ([n for n in cands if self.adapter_redundant_fn(n)]
                     if self.adapter_redundant_fn is not None else [])
        pool = redundant or cands
        victim = min(pool, key=lambda n: self._adapter_lru.get(n, 0))
        if self.on_adapter_shed is not None:
            self.on_adapter_shed(victim)
        self.adapter_free(victim)
        self.adapter_sheds += 1
        return True

    def _shed_any(self, protect_blocks: frozenset = frozenset(),
                  protect_adapters: frozenset = frozenset()) -> bool:
        """One unit of cache pressure: an idle index block if any, else an
        unpinned adapter."""
        return (self._shed_one(protect=protect_blocks)
                or self._shed_adapter(protect=protect_adapters))

    def flush_adapters(self) -> int:
        """Shed every unpinned resident adapter.  Returns adapters shed."""
        n = 0
        while self._shed_adapter():
            n += 1
        return n

    # -- host tier: swap-out preemption, demote / rehydrate ------------------
    @property
    def kv_d2h_bytes(self) -> int:
        """Cumulative device-to-host KV bytes (swap-outs + demotions)."""
        return self.kv_swap_out_bytes + self.kv_demote_bytes

    @property
    def kv_h2d_bytes(self) -> int:
        """Cumulative host-to-device KV bytes (restores + rehydrations)."""
        return self.kv_restore_bytes + self.kv_rehydrate_bytes

    def _layout(self) -> List[Tuple[str, torch.dtype, Tuple[int, ...], int,
                                    int]]:
        """Where a stored block's leaves sit in its ``host_block_bytes``
        unit: ``(name, dtype, shape, byte offset, bytes)`` for each cache
        leaf in order, raw (``[L, bs, g, hd]`` of k) or int8 payload and
        f32 scales (``[L, bs, 1, hd]``) with ``host_quant``."""
        out, off = [], 0
        for name, pool in self.block_leaves.items():
            shape = (pool.shape[0],) + tuple(pool.shape[2:])
            parts = ([(torch.int8, shape),
                      (torch.float32, shape[:-2] + (1, shape[-1]))]
                     if self.host_quant else [(pool.dtype, shape)])
            for dt, shp in parts:
                nb = math.prod(shp) * torch.empty((), dtype=dt).element_size()
                out.append((name, dt, shp, off, nb))
                off += nb
        return out

    def _leaves(self, rows: torch.Tensor) -> Dict[str, List[torch.Tensor]]:
        """Stored blocks' leaves as views ``[L, n, ...]`` of their units
        ``rows`` ``[n, host_block_bytes]`` uint8 (on any device)."""
        n = rows.shape[0]
        out: Dict[str, List[torch.Tensor]] = {k: [] for k in
                                              self.block_leaves}
        for name, dt, shp, off, nb in self._layout():
            out[name].append(rows[:, off:off + nb].view(dt)
                             .view((n,) + shp).transpose(0, 1))
        return out

    @staticmethod
    def _runs(units: Sequence[int]) -> List[List[int]]:
        """``[position, first unit, length]`` of each run of consecutive
        units: one copy a run."""
        out: List[List[int]] = []
        for j, u in enumerate(units):
            if out and out[-1][1] + out[-1][2] == u:
                out[-1][2] += 1
            else:
                out.append([j, u, 1])
        return out

    def _from_arena(self, units: Sequence[int]) -> torch.Tensor:
        """The units' bytes on the device, ``[n, host_block_bytes]``."""
        rows = torch.empty((len(units), self.host_block_bytes),
                           dtype=torch.uint8, device=self.device)
        for j, u, n in self._runs(units):
            rows[j:j + n].copy_(self._arena[u:u + n], non_blocking=True)
        return rows

    def _to_arena(self, rows: torch.Tensor, units: Sequence[int]):
        """Device bytes ``rows`` into the units; complete on return."""
        for j, u, n in self._runs(units):
            self._arena[u:u + n].copy_(rows[j:j + n], non_blocking=True)
        _sync(self.device)

    def _release_units(self, entry: dict):
        self._free_units.extend(entry.get("units", ()))

    def _encode_blocks(self, bids: Sequence[int]) -> List[int]:
        """Gather ``bids``'s leaves (int8-quantized with ``host_quant``) into
        free arena units, one a block; returns the units.  The copies are
        complete when this returns.  The caller has made byte room in the
        host pool, which leaves at least ``len(bids)`` units free."""
        idx = torch.tensor(list(bids), dtype=torch.long, device=self.device)
        parts = []
        for pool in self.block_leaves.values():
            blk = pool.index_select(1, idx)                # [L, n, ...]
            if self.host_quant:
                q = quantize_leaf(blk)
                leaves = (q["_q8"], q["_qs"])
            else:
                leaves = (blk,)
            # block-major bytes, in the order of _layout
            parts += [x.transpose(0, 1).reshape(len(bids), -1)
                      .view(torch.uint8) for x in leaves]
        units = [self._free_units.popleft() for _ in bids]
        # a model with no block leaf (mamba2) stores its 1-byte footprint
        rows = (torch.cat(parts, dim=1) if parts else torch.zeros(
            (len(bids), self.host_block_bytes), dtype=torch.uint8,
            device=self.device))
        self._to_arena(rows, units)
        return units

    def _decode_payload(self, rows: torch.Tensor) -> Dict:
        """Stored blocks (their units' bytes on the device) as leaves
        ``[L, n, bs, ...]`` of the pool's dtype (int8 leaves dequantized on
        the device)."""
        return {name: (dequant_leaf({"_q8": lv[0], "_qs": lv[1]},
                                    self.cache[name].dtype)
                       if self.host_quant else lv[0])
                for name, lv in self._leaves(rows).items()}

    def host_payload(self, entry: dict) -> Dict:
        """A stored entry's leaves as host tensors ``[L, n, bs, ...]``
        (``{"_q8", "_qs"}`` pairs with ``host_quant``): what the host tier
        holds, for checks."""
        lv = self._leaves(self._arena[entry["units"]])
        return {name: ({"_q8": x[0].contiguous(), "_qs": x[1].contiguous()}
                       if self.host_quant else x[0].contiguous())
                for name, x in lv.items()}

    def _blocks_write(self, bids: Sequence[int], payload: Dict):
        """In place: pool blocks ``bids`` get ``payload``'s blocks."""
        idx = torch.tensor(list(bids), dtype=torch.long, device=self.device)
        for name, pool in self.block_leaves.items():
            pool.index_copy_(1, idx, payload[name])

    def swap_payload_blocks(self, slot: int) -> int:
        """Blocks a swap-out of ``slot`` would store: the leading table
        blocks covering its committed tokens."""
        tokens = int(self.lens[slot])
        if tokens <= 0:
            return 0
        return min(-(-tokens // self.block_size),
                   len(self.tables.get(slot, ())))

    def surviving_blocks(self, slot: int, nb: Optional[int] = None) -> int:
        """Of ``slot``'s leading ``nb`` blocks, how many another holder (a
        sibling table, or an index entry with other adopters) keeps on the
        device through a ``free`` and a swap-out de-publish."""
        table = self.tables.get(slot, [])
        nb = len(table) if nb is None else min(nb, len(table))
        n = 0
        for bid in table[:nb]:
            holders = int(self.allocator.ref[bid]) - 1    # minus this table
            if bid in self._hashed:
                holders -= 1                              # minus the index
            if holders >= 1:
                n += 1
        return n

    def swap_out(self, slot: int) -> Optional[int]:
        """Preemption swap-out: gather the blocks covering ``slot``'s
        committed tokens into the host pool as a pinned swap set, then
        de-publish the slot's private index entries (ref == 2) so the free
        reclaims them.  Returns the swap-set id, or None (no host pool,
        nothing committed, or no room): recompute then.  The caller still
        ``free``s the slot."""
        if self.host_pool is None:
            return None
        nb = self.swap_payload_blocks(slot)
        if nb <= 0:
            return None
        nbytes = nb * self.host_block_bytes
        bids = self.tables[slot][:nb]
        # room first (the LRU eviction put_swap would make), so the
        # gather has free arena units
        if not self.host_pool._evict_for(nbytes):
            return None
        entry = {"units": self._encode_blocks(bids), "n": nb,
                 "tokens": int(self.lens[slot]), "bytes": nbytes}
        sid = self.host_pool.put_swap(entry)
        for bid in bids:
            key = self._hashed.get(bid)
            if key is not None and self.allocator.ref[bid] == 2:
                self._depublish(key)
        self.kv_swap_outs += 1
        self.kv_swap_out_bytes += nbytes
        return sid

    def restore_swap(self, slot: int, sid: int) -> int:
        """Re-admission restore: write a swap set's payload into ``slot``'s
        fresh table and consume the set.  The adopted shared run is skipped:
        those blocks arrived by refcount, already hold this content and may
        be shared with live siblings (a write there, above all a dequantized
        one, would break copy-on-write).  The span is clipped one token
        short of the recorded prompt so suffix prefill keeps a live query.
        Returns the prompt tokens covered by adopted + restored K/V."""
        entry = self.host_pool.pop_swap(sid)
        table = self.tables[slot]
        shared = min(self.shared_count.get(slot, 0), len(table))
        tokens = min(entry["tokens"],
                     max(self._seq_len.get(slot, 1) - 1, 0))
        nb = min(-(-tokens // self.block_size) if tokens > 0 else 0,
                 entry["n"], len(table))
        if nb > shared:
            self._blocks_write(table[shared:nb], self._decode_payload(
                self._from_arena(entry["units"][shared:nb])))
            self.kv_restores += 1
            self.kv_restore_bytes += (nb - shared) * self.host_block_bytes
        # the writes are enqueued: a later gather into these units runs
        # after them on the stream
        self._release_units(entry)
        covered = min(tokens, nb * self.block_size)
        return max(covered, shared * self.block_size)

    def drop_swap(self, sid: Optional[int]) -> bool:
        """Release a swap set without restoring it (idempotent)."""
        if self.host_pool is None or sid is None:
            return False
        entry = self.host_pool.pop_swap(sid, missing_ok=True)
        if entry is None:
            return False
        self._release_units(entry)
        self.kv_swap_drops += 1
        return True

    def _rehydrate_wins(self) -> bool:
        """Cost gate of demote/rehydrate: one block's round trip must beat
        recomputing its ``block_size`` tokens (no cost model: free)."""
        if self.cost is None:
            return True
        return swap_beats_recompute(self.host_block_bytes, self.block_size,
                                    self.cost)

    def _demote(self, key: str) -> bool:
        """Capture one about-to-be-shed index block into the host pool's
        demoted cache under its content key (cost-gated, best-effort)."""
        if not self._rehydrate_wins():
            return False
        hp = self.host_pool
        if not hp.has_demoted(key) and not hp._evict_for(
                self.host_block_bytes):
            return False
        entry = {"n": 1, "tokens": self.block_size,
                 "bytes": self.host_block_bytes}
        if not hp.has_demoted(key):   # else put_demoted only refreshes it
            entry["units"] = self._encode_blocks([self._index[key]])
        hp.put_demoted(key, entry)
        self.kv_demotions += 1
        self.kv_demote_bytes += self.host_block_bytes
        return True

    def _rehydrate(self, key: str,
                   protect: frozenset = frozenset()) -> Optional[int]:
        """Bring one demoted block back to the device and publish it (the
        alloc's ref is the index hold; the host entry moves, not copies).
        Spends only spendable capacity, shedding idle cache first; None
        when the key is not demoted or there is no room (entry put back)."""
        if self.host_pool is None or not self.hash_dedup:
            return None
        got = self._index.get(key)
        if got is not None:
            return got
        hp = self.host_pool
        entry = hp.pop_demoted(key)
        if entry is None:
            return None
        # popped before shedding: the shed loop may demote into the host
        # LRU, which must not evict this entry.  Its bytes move to the
        # device and its unit is freed, so the units stay as many as the
        # pool's byte budget says
        rows = self._from_arena(entry["units"])
        self._release_units(entry)
        while (self.free_blocks <= 0
               and self._shed_any(protect_blocks=protect)):
            pass
        if self.free_blocks <= 0:
            if hp._evict_for(entry["bytes"]):      # put back, as it was
                entry["units"] = [self._free_units.popleft()]
                self._to_arena(rows, entry["units"])
                hp.put_demoted(key, entry)
            return None
        bid = self.allocator.alloc()
        if bid is None:                      # free_blocks > 0 => n_free > 0
            raise KVAccountingError(
                "spendable budget positive but the pool has no free block")
        self._blocks_write([bid], self._decode_payload(rows))
        self._index[key] = bid
        self._hashed[bid] = key
        self._hits.setdefault(key, 0)
        self.kv_rehydrations += 1
        self.kv_rehydrate_bytes += self.host_block_bytes
        if self.on_publish is not None:
            self.on_publish(key, bid)
        return bid

    def flush_host(self) -> int:
        """Drop every demoted host entry.  Returns entries dropped."""
        if self.host_pool is None:
            return 0
        return self.host_pool.flush_demoted()

    # -- fleet import --------------------------------------------------------
    def import_block(self, key: str, src: "PagedCacheManager",
                     src_bid: int) -> Optional[int]:
        """Fetch one content-addressed block from a sibling manager's pool
        (the fleet's remote fetch): allocate a local block, copy the K/V
        payload across pools and publish it in the local index under the
        same key, as an index-only block (ref 1) like a locally published
        idle one.  The key is the content, and published blocks are
        copy-on-write immutable, so the copy is what local recompute would
        write.  Spends only spendable capacity, shedding idle index entries
        first; None when the pool cannot take the block (the caller then
        recomputes).  Returns the local block id."""
        if not self.hash_dedup:
            return None
        got = self._index.get(key)
        if got is not None:
            return got                       # already resident locally
        while self._index and self.free_blocks <= 0:
            if not self._shed_one():
                break
        if self.free_blocks <= 0:
            return None
        bid = self.allocator.alloc()
        if bid is None:                      # free_blocks > 0 => n_free > 0
            raise KVAccountingError(
                "spendable budget positive but the pool has no free block")
        self._copy_block_from(src, src_bid, bid)
        # alloc's ref of 1 is the index's hold
        self._index[key] = bid
        self._hashed[bid] = key
        self._hits.setdefault(key, 0)
        self.remote_imports += 1
        if self.host_pool is not None:
            # the remote copy supersedes a demoted host copy (one tier per
            # key)
            self.host_pool.drop_demoted(key)
        if self.on_publish is not None:
            self.on_publish(key, bid)
        return bid

    def _copy_block_from(self, src: "PagedCacheManager", src_bid: int,
                         dst_bid: int):
        """In place: block ``dst_bid`` of every layer's pool gets block
        ``src_bid`` of ``src``'s, a copy on the card (the JAX package
        returns a new cache instead).  Both pools must have one shape, dtype
        and device: a block never moves through the host here.  The state
        rows are per-request, not blocks, and never cross pools."""
        if self.cache.keys() != src.cache.keys():
            raise ValueError(f"cross-pool copy between unlike caches: "
                             f"{list(src.cache)} -> {list(self.cache)}")
        for name, dst in self.block_leaves.items():
            got = src.cache[name]
            if (dst.shape[0] != got.shape[0] or dst.shape[2:] != got.shape[2:]
                    or dst.dtype != got.dtype or dst.device != got.device):
                raise ValueError(
                    f"cross-pool copy between unlike pools: {name} "
                    f"{tuple(got.shape)} {got.dtype} {got.device} -> "
                    f"{tuple(dst.shape)} {dst.dtype} {dst.device}")
            dst[:, dst_bid] = got[:, src_bid]

    # -- copy-on-write -------------------------------------------------------
    def _copy_block(self, src: int, dst: int):
        """In place: block ``dst`` of every layer's pool gets ``src``'s
        payload (the JAX package returns a new cache instead); the state
        rows stay as they are."""
        for pool in self.block_leaves.values():
            pool[:, dst] = pool[:, src]

    def ensure_writable(self, slot: int, pos: Optional[int] = None) -> int:
        """Guarantee the block holding ``pos`` (default: the next write) is
        exclusively owned; copy-on-write it if shared.  Returns the block
        id.  Under the conservative gate the fork spends only spendable
        blocks; under lending it is a mandatory write and spends any truly
        free block (shedding then would destroy the index blocks that make
        preemption cheap)."""
        p = int(self.lens[slot]) if pos is None else pos
        bi = p // self.block_size
        table = self.tables[slot]
        if bi >= len(table):
            self.grow(slot, p + 1)
        bid = table[bi]
        if not self.allocator.is_shared(bid):
            return bid

        def _spendable():
            return (self.free_blocks if self.over_admit <= 1.0
                    else self.allocator.n_free)
        while _spendable() <= 0 and self._shed_any():
            pass
        new = self.allocator.alloc() if _spendable() > 0 else None
        if new is None:
            raise OutOfBlocksError("out of KV blocks during copy-on-write")
        self._copy_block(bid, new)
        self.allocator.decref(bid)
        table[bi] = new
        # the fork de-publishes the slot's claim on this position
        chain = self._chains.get(slot)
        if chain is not None:
            del chain[bi:]
        self._touch_lent()
        return new

    # -- batch assembly ------------------------------------------------------
    def table_of(self, slot: int) -> np.ndarray:
        """Null-padded ``[nbt]`` int32 table for the batch."""
        t = np.zeros((self.nbt,), np.int32)
        bids = self.tables[slot]
        t[:len(bids)] = bids
        return t

    def write_table_of(self, slot: int) -> np.ndarray:
        """Prefill-write table: adopted prefix entries are nulled so prefill
        never rewrites blocks it does not exclusively own."""
        t = self.table_of(slot)
        t[:self.shared_count.get(slot, 0)] = 0
        return t

    def dec_tables(self, active_slots) -> np.ndarray:
        """Decode-bucket tables ``[capacity, nbt]``: only active slots get
        their real tables; padding rows stay on the null block."""
        out = np.zeros((self.capacity, self.nbt), np.int32)
        for slot in active_slots:
            bids = self.tables[slot]
            out[slot, :len(bids)] = bids
        return out

    # -- step plumbing -------------------------------------------------------
    def step_cache(self):
        return self.cache

    def update(self, new_cache):
        """No-op: the model wrote the pool in place (``new_cache`` is
        ``self.cache``)."""

    def commit_prefill(self, assignments: List[Tuple[int, int]],
                       lengths: List[int], src_base: Optional[int] = None):
        """Prefill K/V went straight into the request's blocks: commit is
        the per-request state row copy (``STATE_KEYS``: a Mamba model's
        state, a cross model's ``xk`` / ``xv``;
        prefill row ``i`` at ``src_base + i``, ``src_base`` defaulting to
        ``capacity``, into its decode slot; every source is gathered before
        any destination is written), the length assignment and the
        publication point for the prompt blocks the chunk filled."""
        if not assignments:
            return
        state = [v for k, v in self.cache.items() if k in STATE_KEYS]
        if state:
            base = self.capacity if src_base is None else src_base
            src = torch.tensor([base + i for i, _ in assignments],
                               device=self.device)
            dst = torch.tensor([s for _, s in assignments],
                               device=self.device)
            for rows in state:
                rows[:, dst] = rows[:, src]       # the gather copies first
        for (_, slot), ln in zip(assignments, lengths):
            self.lens[slot] = ln
            self._publish_upto(slot)
