"""Unified computation-flow planning (host side of Algorithms 1-2).

Port of the serving half of ``repro.core.flow``: heterogeneous pending work
(prefill requests, decode slots or verify chunks) becomes ONE
``UnifiedBatch`` whose shapes snap to bucket grids, with every prefill row
padded to a multiple of ``block_t`` so that each SMLM token tile is
adapter-uniform.  Padding rows carry ``adapter = -1`` (base only).
Tensors are built on the engine's device.  The fine-tune planner
(``plan_ft``) comes with the training slice.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models.stream import DECBatch, PFBatch, UnifiedBatch


@dataclasses.dataclass(frozen=True)
class FlowConfig:
    # SMLM token tile: every prefill segment is padded to it, and the
    # dispatch runs SMLM at exactly this tile (the CUDA kernel takes any).
    block_t: int = 8
    row_buckets: Tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64, 128)
    seq_buckets: Tuple[int, ...] = (16, 32, 64, 128, 256, 512, 1024, 2048,
                                    4096, 8192, 16384, 32768)


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


def plan_pf(reqs: List[PFReq], fcfg: FlowConfig,
            device: torch.device) -> Optional[PFBatch]:
    if not reqs:
        return None
    if reqs[0].aux_embed is not None:
        raise NotImplementedError("modality embeddings are not ported")
    Bp = bucket(len(reqs), fcfg.row_buckets)
    Sp = _pad_seq(max(len(r.tokens) for r in reqs), fcfg)
    toks = np.zeros((Bp, Sp), np.int32)
    length = np.zeros((Bp,), np.int32)
    adapter = np.full((Bp,), -1, np.int32)
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
        if tables is not None:
            tables[i] = r.block_table
        if cached is not None:
            cached[i] = r.cached_len or 0
    return PFBatch(tokens=_t(toks, device), length=_t(length, device),
                   adapter=_t(adapter, device),
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


def assemble(pf_reqs: List[PFReq],
             dec_tokens: np.ndarray, dec_pos: np.ndarray,
             dec_slots: np.ndarray, fcfg: FlowConfig, device: torch.device,
             dec_tables: Optional[np.ndarray] = None,
             dec_lens: Optional[np.ndarray] = None) -> UnifiedBatch:
    return UnifiedBatch(pf=plan_pf(pf_reqs, fcfg, device),
                        dec=plan_dec(dec_tokens, dec_pos, dec_slots, device,
                                     dec_tables, dec_lens))


def token_adapter_ids(batch: UnifiedBatch) -> np.ndarray:
    """Per-token adapter ids of the flattened stream (mirrors model._Plan)."""
    ids = []
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
    if batch.pf is None:
        return True
    Bp, Sp = batch.pf.tokens.shape
    if Sp % block_t:
        return False
    tiles = np.repeat(batch.pf.adapter.cpu().numpy(), Sp).reshape(-1,
                                                                   block_t)
    return bool((tiles == tiles[:, :1]).all())
