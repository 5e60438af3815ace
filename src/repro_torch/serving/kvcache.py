"""Engine-side KV cache management: dense rows and paged blocks.

Port of the part of ``repro.serving.kvcache`` that the engine uses.

**Dense** (``CacheManager``, ``EngineConfig(paged=False)``): the cache has
``capacity + pf_capacity`` rows of ``s_max`` key/value slots per layer
(``init_cache``); rows ``[0, capacity)`` are the persistent decode table,
and each step's prefill writes rows ``[Bd, Bd + Bp)`` (``Bd`` is that tick's
decode-bucket size).  After the step ``commit_prefill`` copies the freshly
prefilled rows into their decode slots.  Every resident request pays
``s_max`` slots whether it uses them or not.

**Paged** (``PagedCacheManager``, the default): attention K/V lives in a flat pool of fixed-size blocks (``init_paged_cache``:
``[L, n_blocks, block_size, g, hd]`` on the engine's device); each request
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
of the pool tensors.  The host block tier, unified adapter paging, fleet
block import and over-admission lending belong to later slices and raise.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict, deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.errors import ConfigInvariantError, InvariantError
from repro_torch.models.configs import ModelConfig
from repro_torch.models.model import init_cache, init_paged_cache


class KVAccountingError(InvariantError):
    """A block-accounting invariant was violated: refcount misuse, or a
    within-reservation ``grow`` finding an empty pool under the conservative
    gate (which guarantees ``n_free >= debt``)."""


class OutOfBlocksError(RuntimeError):
    """The pool could not supply a block for a mandatory write (a
    copy-on-write fork)."""


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
        dev = self.cache["k"].device
        src = torch.tensor([base + i for i, _ in assignments], device=dev)
        dst = torch.tensor([s for _, s in assignments], device=dev)
        for name in ("k", "v"):
            rows = self.cache[name]
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
    """Block-table paged KV cache with the content-hash dedup index."""

    def __init__(self, cfg: ModelConfig, capacity: int, pf_capacity: int,
                 s_max: int, *, device: torch.device, dtype: torch.dtype,
                 block_size: int = 32, n_blocks: int = 0,
                 over_admit: float = 1.0, hash_dedup: bool = True,
                 host_blocks: int = 0):
        if cfg.sliding_window > 0:
            raise ValueError("paged cache does not support sliding windows")
        if over_admit != 1.0:
            raise NotImplementedError(
                "over_admit (reservation lending) comes with a later "
                "engine-features slice")
        if host_blocks:
            raise NotImplementedError(
                "kv_host_blocks (the host KV tier) comes with a later "
                "engine-features slice")
        self.cfg = cfg
        self.hash_dedup = bool(hash_dedup)
        self.hash_hits = 0                # blocks adopted via the index
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
                                      dtype)
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

    # -- budget --------------------------------------------------------------
    @property
    def n_free(self) -> int:
        return len(self._free_slots)

    @property
    def free_blocks(self) -> int:
        """Blocks the admission gate may spend: the free list minus the
        reservation debt of admitted requests (conservative gate)."""
        return self.allocator.n_free - self._debt

    @property
    def reserved_debt(self) -> int:
        return self._debt

    @property
    def total_blocks(self) -> int:
        return self.allocator.usable

    def projected_blocks(self, prompt_len: int, max_new: int) -> int:
        return projected_blocks(prompt_len, max_new, self.block_size,
                                self.s_max)

    def _debt_of(self, slot: int) -> int:
        return max(self.reserved.get(slot, 0) - len(self.tables[slot]), 0)

    @property
    def reclaimable_blocks(self) -> int:
        """Blocks held only by the hash index (ref == 1): pure cache,
        sheddable on demand, so the admission gate counts them available."""
        if not self._hashed:
            return 0
        bids = np.fromiter(self._hashed, np.int64, len(self._hashed))
        return int(np.count_nonzero(self.allocator.ref[bids] == 1))

    @property
    def hash_blocks_resident(self) -> int:
        return len(self._index)

    @property
    def pristine(self) -> bool:
        """Post-drain invariant: no live tables, no reservation debt, and
        every non-free block is held only by the hash index."""
        return (not self.tables and self._debt == 0
                and self.allocator.n_free + self.reclaimable_blocks
                == self.allocator.usable)

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
        the longest index-resident run of its key chain, but allocate only
        the blocks the prompt needs now.  Returns ``(slot, reused prefix
        tokens)`` or None when slots or spendable blocks are exhausted.
        ``priority`` only orders lending, which this slice does not do."""
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
            adopt_keys = list(keys[:len(shared)])
        now_need = min(self.projected_blocks(len(prompt), 0), need)
        fresh_need = need - len(shared)
        fresh_now = max(now_need - len(shared), 0)
        if fresh_need > self.free_blocks:
            # shed idle index blocks to make room, never the run this
            # admission is about to adopt
            protect = frozenset(shared)
            while (fresh_need > self.free_blocks
                   and self._shed_one(protect=protect)):
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
        self._debt += self._debt_of(slot)
        self.lens[slot] = 0
        n_rec = min(len(prompt), self.s_max)
        buf = np.zeros((self.s_max,), np.int64)
        buf[:n_rec] = np.asarray(prompt[:n_rec], np.int64)
        self._seqs[slot] = buf
        self._seq_len[slot] = n_rec
        self._chains[slot] = adopt_keys
        self._adapters[slot] = adapter
        self._share[slot] = share
        return slot, len(shared) * self.block_size

    def free(self, slot: int):
        self._debt -= self._debt_of(slot)
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
        """Extend ``slot``'s table to cover ``new_len`` tokens.  Growth
        within the reservation always succeeds under the conservative gate
        (an empty pool there raises ``KVAccountingError``); growth beyond
        it is best-effort.  Returns the token capacity now covered."""
        table = self.tables[slot]
        target = min(-(-new_len // self.block_size), self.nbt)
        while len(table) < target:
            within = len(table) < self.reserved.get(slot, 0)
            if not within and self.free_blocks <= 0:
                break                       # transient overshoot, pool dry
            d0 = self._debt_of(slot)
            bid = self.allocator.alloc()
            while bid is None and self._shed_one():
                bid = self.allocator.alloc()
            if bid is None:
                if within:
                    raise KVAccountingError(
                        "reservation debt accounting violated: within-"
                        "reservation grow found an empty pool")
                break
            table.append(bid)
            self._debt += self._debt_of(slot) - d0
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
            self._debt += self._debt_of(slot) - d0
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

    def _depublish(self, key: str):
        bid = self._index.pop(key)
        del self._hashed[bid]
        self._hits.pop(key, None)
        self.allocator.decref(bid)

    def _shed_one(self, protect: frozenset = frozenset()) -> bool:
        """Evict one index entry whose block only the index holds: zero-hit
        first (publication order), then the lowest adoption count.  Every
        scan halves every hit count after choosing (hit aging)."""
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
        self._depublish(best[1])
        return True

    # -- copy-on-write -------------------------------------------------------
    def _copy_block(self, src: int, dst: int):
        """In place: block ``dst`` of every layer's pool gets ``src``'s
        payload (the JAX package returns a new cache instead)."""
        for pool in (self.cache["k"], self.cache["v"]):
            pool[:, dst] = pool[:, src]

    def ensure_writable(self, slot: int, pos: Optional[int] = None) -> int:
        """Guarantee the block holding ``pos`` (default: the next write) is
        exclusively owned; copy-on-write it if shared.  Returns the block
        id.  The fork spends only the conservative gate's spendable
        blocks."""
        p = int(self.lens[slot]) if pos is None else pos
        bi = p // self.block_size
        table = self.tables[slot]
        if bi >= len(table):
            self.grow(slot, p + 1)
        bid = table[bi]
        if not self.allocator.is_shared(bid):
            return bid
        while self.free_blocks <= 0 and self._shed_one():
            pass
        new = self.allocator.alloc() if self.free_blocks > 0 else None
        if new is None:
            raise OutOfBlocksError("out of KV blocks during copy-on-write")
        self._copy_block(bid, new)
        self.allocator.decref(bid)
        table[bi] = new
        # the fork de-publishes the slot's claim on this position
        chain = self._chains.get(slot)
        if chain is not None:
            del chain[bi:]
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
        the length assignment plus the publication point for the prompt
        blocks the chunk filled.  ``src_base`` names the state rows of
        models that have them; the attention-only decoder has none."""
        for (_, slot), ln in zip(assignments, lengths):
            self.lens[slot] = ln
            self._publish_upto(slot)
