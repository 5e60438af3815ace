"""Unified computation-flow planning (host side of Algorithms 1-2).

Port of ``repro.core.flow``: heterogeneous pending work (fine-tune and
evaluation rows, prefill requests, decode slots or verify chunks) becomes
ONE ``UnifiedBatch`` whose shapes snap to bucket grids, with every ft and
prefill row padded to a multiple of ``block_t`` so that each SMLM token tile
is adapter-uniform.  Padding rows carry ``adapter = -1`` (base only) and
zero loss weight.  A bucket whose first row carries ``aux_embed`` (the
cross-attention source) carries one ``[B, F, d]`` float32 tensor, zeros on
padding rows.  Tensors are built on the engine's device.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models.stream import DECBatch, FTBatch, PFBatch, \
    UnifiedBatch


@dataclasses.dataclass(frozen=True)
class FlowConfig:
    # SMLM token tile: every ft/prefill segment is padded to it, and the
    # dispatch runs SMLM at exactly this tile (the CUDA kernel takes any).
    block_t: int = 8
    row_buckets: Tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64, 128)
    seq_buckets: Tuple[int, ...] = (16, 32, 64, 128, 256, 512, 1024, 2048,
                                    4096, 8192, 16384, 32768)


@dataclasses.dataclass
class FTRow:
    tokens: np.ndarray               # [L] int
    labels: np.ndarray               # [L] int (-100 ignore)
    slot: int                        # adapter slot (-1 = base)
    weight: float = 1.0              # per-row loss scale (1/accum etc.)
    trainer: Optional[str] = None    # owning trainer (loss bookkeeping)
    is_eval: bool = False
    aux_embed: Optional[np.ndarray] = None


@dataclasses.dataclass
class PFReq:
    tokens: np.ndarray               # [L] prompt (or uncached suffix/chunk)
    slot: int
    rid: int = -1
    aux_embed: Optional[np.ndarray] = None
    block_table: Optional[np.ndarray] = None  # [nbt] int32 (paged layout)
    cached_len: Optional[int] = None  # prefix tokens already in the blocks


def bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if b >= n:
            return b
    return buckets[-1] if n <= buckets[-1] else n


def _pad_seq(n: int, fcfg: FlowConfig) -> int:
    b = bucket(n, fcfg.seq_buckets)
    return ((b + fcfg.block_t - 1) // fcfg.block_t) * fcfg.block_t


def _t(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _aux(rows, B: int) -> Optional[np.ndarray]:
    """The bucket's ``[B, F, d]`` float32 cross source, zeros on padding
    rows, when its first row carries one (the JAX planner's rule)."""
    if rows[0].aux_embed is None:
        return None
    return np.zeros((B, *rows[0].aux_embed.shape), np.float32)


def plan_ft(rows: List[FTRow], fcfg: FlowConfig,
            device: torch.device) -> Optional[FTBatch]:
    if not rows:
        return None
    Bf = bucket(len(rows), fcfg.row_buckets)
    Sf = _pad_seq(max(len(r.tokens) for r in rows), fcfg)
    toks = np.zeros((Bf, Sf), np.int32)
    mask = np.zeros((Bf, Sf), bool)
    labels = np.full((Bf, Sf), -100, np.int32)
    adapter = np.full((Bf,), -1, np.int32)
    weight = np.zeros((Bf,), np.float32)
    aux = _aux(rows, Bf)
    for i, r in enumerate(rows):
        L = len(r.tokens)
        toks[i, :L] = r.tokens
        mask[i, :L] = True
        labels[i, :L] = r.labels
        adapter[i] = r.slot
        weight[i] = 0.0 if r.is_eval else r.weight
        if aux is not None:
            aux[i] = r.aux_embed
    return FTBatch(tokens=_t(toks, device), mask=_t(mask, device),
                   labels=_t(labels, device), adapter=_t(adapter, device),
                   weight=_t(weight, device),
                   aux_embed=_t(aux, device) if aux is not None else None)


def plan_pf(reqs: List[PFReq], fcfg: FlowConfig,
            device: torch.device) -> Optional[PFBatch]:
    if not reqs:
        return None
    Bp = bucket(len(reqs), fcfg.row_buckets)
    Sp = _pad_seq(max(len(r.tokens) for r in reqs), fcfg)
    toks = np.zeros((Bp, Sp), np.int32)
    length = np.zeros((Bp,), np.int32)
    adapter = np.full((Bp,), -1, np.int32)
    aux = _aux(reqs, Bp)
    tables = None
    if reqs[0].block_table is not None:
        tables = np.zeros((Bp, len(reqs[0].block_table)), np.int32)
    # suffix-only prefill: one row carrying a cached prefix makes the whole
    # bucket positional (cold and padding rows get cached_len 0)
    cached = None
    if any(r.cached_len is not None for r in reqs):
        cached = np.zeros((Bp,), np.int32)
    for i, r in enumerate(reqs):
        L = len(r.tokens)
        toks[i, :L] = r.tokens
        length[i] = L
        adapter[i] = r.slot
        if aux is not None:
            aux[i] = r.aux_embed
        if tables is not None:
            tables[i] = r.block_table
        if cached is not None:
            cached[i] = r.cached_len or 0
    return PFBatch(tokens=_t(toks, device), length=_t(length, device),
                   adapter=_t(adapter, device),
                   aux_embed=_t(aux, device) if aux is not None else None,
                   block_tables=(_t(tables, device) if tables is not None
                                 else None),
                   cached_len=(_t(cached, device) if cached is not None
                               else None))


def plan_dec(tokens: np.ndarray, pos: np.ndarray, slots: np.ndarray,
             device: torch.device, tables: Optional[np.ndarray] = None,
             lengths: Optional[np.ndarray] = None) -> Optional[DECBatch]:
    """``tokens`` is [Bd] for plain decode or [Bd, Sd] for speculative
    verify chunks; ``lengths`` gives each row's valid chunk length."""
    if len(tokens) == 0:
        return None
    as32 = lambda a: _t(np.asarray(a, np.int32), device)
    return DECBatch(tokens=as32(tokens), pos=as32(pos), adapter=as32(slots),
                    block_tables=as32(tables) if tables is not None else None,
                    length=as32(lengths) if lengths is not None else None)


def assemble(ft_rows: List[FTRow], pf_reqs: List[PFReq],
             dec_tokens: np.ndarray, dec_pos: np.ndarray,
             dec_slots: np.ndarray, fcfg: FlowConfig, device: torch.device,
             dec_tables: Optional[np.ndarray] = None,
             dec_lens: Optional[np.ndarray] = None) -> UnifiedBatch:
    return UnifiedBatch(ft=plan_ft(ft_rows, fcfg, device),
                        pf=plan_pf(pf_reqs, fcfg, device),
                        dec=plan_dec(dec_tokens, dec_pos, dec_slots, device,
                                     dec_tables, dec_lens))


def token_adapter_ids(batch: UnifiedBatch) -> np.ndarray:
    """Per-token adapter ids of the flattened stream (mirrors model._Plan)."""
    ids = []
    if batch.ft is not None:
        Sf = batch.ft.tokens.shape[1]
        ids.append(np.repeat(batch.ft.adapter.cpu().numpy(), Sf))
    if batch.pf is not None:
        Sp = batch.pf.tokens.shape[1]
        ids.append(np.repeat(batch.pf.adapter.cpu().numpy(), Sp))
    if batch.dec is not None:
        tok = batch.dec.tokens
        Sd = tok.shape[1] if tok.ndim == 2 else 1
        ids.append(np.repeat(batch.dec.adapter.cpu().numpy(), Sd))
    return np.concatenate(ids) if ids else np.zeros((0,), np.int32)


def smlm_tile_aligned(batch: UnifiedBatch, block_t: int) -> bool:
    """The SMLM contract: within the ft+pf head of the stream, every
    ``block_t`` token tile is adapter-uniform (the decode tail goes through
    the per-token BGMV kernel, so it is exempt)."""
    ids = []
    for b in (batch.ft, batch.pf):
        if b is None:
            continue
        S = b.tokens.shape[1]
        if S % block_t:
            return False
        ids.append(np.repeat(b.adapter.cpu().numpy(), S))
    if not ids:
        return True
    tiles = np.concatenate(ids).reshape(-1, block_t)
    return bool((tiles == tiles[:, :1]).all())
