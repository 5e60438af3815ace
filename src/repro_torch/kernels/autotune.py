"""Split choice for the paged-attention kernels (port of
``repro.kernels.autotune``).

The split-K kernels need a ``num_splits``; this module owns that choice per
shape key ``(head_dim, block_size, nbt, bh)``, where ``bh`` is the batch
parallelism of the attention grid.  The JAX model passes ``Bd * n_heads``,
one TPU grid cell per query head; the port's kernels run one thread block
per (request, KV head), so the port's model passes ``Bd * n_kv_heads``.
``heuristic`` and ``choose`` are the JAX package's for the same arguments:

* a tuning TABLE: an in-memory dict, loadable from and savable to a small
  JSON file in the JAX package's layout, filled by ``sweep`` (with a
  measured ``measure`` on the card, or the occupancy model below);
* a deterministic HEURISTIC fallback for any shape the table misses.

The occupancy model: the device runs ``lanes`` grid cells at once.  The
sequential walk costs ``ceil(bh / lanes) * nbt`` block visits; an
``ns``-way split costs ``ceil(bh * ns / lanes) * ceil(nbt / ns)`` plus a
small merge.  Splitting wins only when ``bh`` alone cannot fill the lanes
(long context, small batch).  The port's lanes are the card's SM count
(``multi_processor_count``, 132 on an H100 SXM), not the JAX package's
modeled ``LANES = 16``; off the card they are the H100 SXM's 132, so a CPU
run makes the choice the card would.  Nothing is loaded at import: the
checked-in ``attn_tune.json`` came from a modeled TPU/CPU occupancy.

``choose`` memoizes its answer per (key, lanes, table version), so the
model pays one dict lookup per forward; every table mutation bumps
``table_version()``, which invalidates the memo.

``splits_h100.json`` beside this module is the table that
``chip_smoke.py --tune-splits`` measured on an H100 (``sweep`` with
every candidate timed at the smoke's serving and long-context buckets);
the model merges it at its first call on a card with the table's lane
count (``load_card_table``), never at import and never for a CPU run.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Callable, Dict, Iterable, NamedTuple, Optional, Tuple

import torch

H100_SMS = 132              # lanes off the card (H100 SXM SM count)
SPLIT_CANDIDATES = (1, 2, 4, 8, 16)
# below this many blocks per split the per-split fixed costs (q load, merge
# traffic) dominate: don't shard a walk that short
MIN_BLOCKS_PER_SPLIT = 4
_MERGE_FIXED = 1.0          # merge launch, in block-visit units
_MERGE_PER_SPLIT = 0.25     # per-partial merge traffic, same units

ShapeKey = Tuple[int, int, int, int]       # (head_dim, block_size, nbt, bh)


class AttnConfig(NamedTuple):
    """One tuning decision for a shape key (the JAX package's layout)."""
    block_k: int             # KV tile of the JAX linear-cache decode kernel;
    #                          the paged kernels walk one pool block at a time
    num_splits: int          # split-K fan-out (1 = sequential walk)


_TABLE: Dict[ShapeKey, AttnConfig] = {}
_VERSION = 0
_CHOSEN: Dict[Tuple[ShapeKey, int, int], AttnConfig] = {}
_SMS: Dict[int, int] = {}
CARD_TABLE = Path(__file__).with_name("splits_h100.json")
_CARD_LOADED = False


def table_version() -> int:
    """Monotone counter bumped on every table mutation."""
    return _VERSION


def effective_lanes(device: Optional[torch.device] = None) -> int:
    """Concurrent grid cells of the occupancy model: the SM count of
    ``device`` (default: the current CUDA device, if any), or ``H100_SMS``
    for a CPU device or a machine without a card."""
    if device is None:
        if not torch.cuda.is_available():
            return H100_SMS
        device = torch.device("cuda")
    device = torch.device(device)
    if device.type != "cuda":
        return H100_SMS
    idx = torch.cuda.current_device() if device.index is None \
        else device.index
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def put_config(key: ShapeKey, cfg: AttnConfig) -> None:
    global _VERSION
    _TABLE[tuple(int(k) for k in key)] = AttnConfig(int(cfg[0]), int(cfg[1]))
    _VERSION += 1


def clear_table() -> None:
    global _VERSION
    _TABLE.clear()
    _VERSION += 1


def get_config(key: ShapeKey) -> Optional[AttnConfig]:
    return _TABLE.get(tuple(int(k) for k in key))


def modeled_grid_time(bh: int, nbt: int, num_splits: int,
                      lanes: int) -> float:
    """Occupancy-model cost (in block visits) of one attention launch:
    waves of ``lanes`` concurrent cells, each walking its share of the
    table, plus the merge when split."""
    ns = max(1, int(num_splits))
    npb = -(-nbt // ns)
    waves = -(-bh * ns // lanes)
    t = float(waves * npb)
    if ns > 1:
        t += _MERGE_FIXED + _MERGE_PER_SPLIT * ns * (-(-bh // lanes))
    return t


def candidate_splits(nbt: int) -> Tuple[int, ...]:
    """Split counts worth trying for a table of ``nbt`` blocks."""
    return tuple(ns for ns in SPLIT_CANDIDATES
                 if ns == 1 or -(-nbt // ns) >= MIN_BLOCKS_PER_SPLIT)


def default_block_k(head_dim: int) -> int:
    """The JAX linear-cache decode tile, kept for the table's layout."""
    return 512 if head_dim <= 64 else 256


def heuristic(head_dim: int, block_size: int, nbt: int, bh: int,
              lanes: Optional[int] = None) -> AttnConfig:
    """Deterministic fallback: minimize the occupancy model over the
    candidate splits (ties -> fewer splits)."""
    lanes = effective_lanes() if lanes is None else lanes
    best, best_t = 1, modeled_grid_time(bh, nbt, 1, lanes)
    for ns in candidate_splits(nbt):
        t = modeled_grid_time(bh, nbt, ns, lanes)
        if t < best_t:
            best, best_t = ns, t
    return AttnConfig(default_block_k(head_dim), best)


def choose(head_dim: int, block_size: int, nbt: int, bh: int,
           lanes: Optional[int] = None) -> AttnConfig:
    """Table lookup with heuristic fallback, memoized: the one entry point
    the model calls, once per forward."""
    lanes = effective_lanes() if lanes is None else lanes
    key = (int(head_dim), int(block_size), int(nbt), int(bh))
    memo = (key, lanes, _VERSION)
    got = _CHOSEN.get(memo)
    if got is None:
        got = get_config(key) or heuristic(*key, lanes=lanes)
        _CHOSEN[memo] = got
    return got


# ------------------------------------------------------------- persistence

def save_table(path: str) -> int:
    """Write the in-memory table as JSON; returns the entry count."""
    doc = {"lanes": effective_lanes(),
           "entries": {",".join(str(k) for k in key): list(cfg)
                       for key, cfg in sorted(_TABLE.items())}}
    with open(path, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")
    return len(_TABLE)


def load_table(path: str) -> int:
    """Merge a JSON tuning table into the in-memory one (one version bump);
    returns the number of entries loaded."""
    global _VERSION
    with open(path) as f:
        doc = json.load(f)
    entries = doc.get("entries", {})
    for skey, val in entries.items():
        key = tuple(int(p) for p in skey.split(","))
        if len(key) != 4 or len(val) != 2:
            raise ValueError(f"malformed tuning entry {skey!r}: {val!r}")
        _TABLE[key] = AttnConfig(int(val[0]), int(val[1]))
    _VERSION += 1
    return len(entries)


def load_card_table(device: torch.device) -> int:
    """Merge ``CARD_TABLE`` into the table once per process, when
    ``device`` is a CUDA device whose lane count is the table's; returns
    the entries merged (0 when it was merged before or does not apply)."""
    global _CARD_LOADED
    device = torch.device(device)
    if _CARD_LOADED or device.type != "cuda" or not CARD_TABLE.exists():
        return 0
    _CARD_LOADED = True
    with open(CARD_TABLE) as f:
        lanes = json.load(f).get("lanes")
    if lanes != effective_lanes(device):
        return 0
    return load_table(str(CARD_TABLE))


# ------------------------------------------------------------------ sweep

def sweep(shapes: Iterable[ShapeKey],
          measure: Optional[Callable[[ShapeKey, AttnConfig], float]] = None,
          lanes: Optional[int] = None) -> Dict[ShapeKey, AttnConfig]:
    """Fill the table for ``shapes``: score every candidate split with
    ``measure((hd, bs, nbt, bh), cfg) -> seconds`` (timed on the card) or,
    when None, with the occupancy model.  Returns the chosen configs (also
    stored via ``put_config``)."""
    lanes = effective_lanes() if lanes is None else lanes
    chosen: Dict[ShapeKey, AttnConfig] = {}
    for key in shapes:
        hd, bs, nbt, bh = (int(k) for k in key)
        best_cfg, best_t = None, None
        for ns in candidate_splits(nbt):
            cfg = AttnConfig(default_block_k(hd), ns)
            t = (measure((hd, bs, nbt, bh), cfg) if measure is not None
                 else modeled_grid_time(bh, nbt, ns, lanes))
            if best_t is None or t < best_t:
                best_cfg, best_t = cfg, t
        chosen[(hd, bs, nbt, bh)] = best_cfg
        put_config((hd, bs, nbt, bh), best_cfg)
    return chosen
