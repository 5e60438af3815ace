"""Unified token-stream batch types (the paper's four request kinds), holding
torch tensors.  Same fields and layouts as ``repro.models.stream``; any subset
of (ft, pf, dec) may be present: fine-tune and evaluation rows (``FTBatch``;
evaluation rows carry weight 0, so they add no gradient), prefill rows, and
decode rows (plain decode or speculative verify chunks).  ``aux_embed`` is
the cross-attention source of a row (precomputed image-patch or audio-frame
embeddings, zeros on padding rows); a model without cross layers ignores
it."""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

Tensor = torch.Tensor


class FTBatch(NamedTuple):
    tokens: Tensor                   # [Bf, Sf] int32 (right-padded)
    mask: Tensor                     # [Bf, Sf] bool valid tokens
    labels: Tensor                   # [Bf, Sf] int32 (-100 = ignore)
    adapter: Tensor                  # [Bf] int32 (-1 = base only)
    weight: Tensor                   # [Bf] f32 per-row loss scale (1/accum)
    aux_embed: Optional[Tensor] = None  # [Bf, F, d] f32 cross source


class PFBatch(NamedTuple):
    """Prefill bucket.  With ``cached_len`` set (paged layout), rows are
    *suffixes* whose absolute positions start at ``cached_len``: the prefix
    K/V already sits in the request's blocks and is read, not recomputed."""
    tokens: Tensor                   # [Bp, Sp] int32 (right-padded)
    length: Tensor                   # [Bp] int32 true (suffix) lengths
    adapter: Tensor                  # [Bp] int32
    aux_embed: Optional[Tensor] = None  # [Bp, F, d] f32 cross source
    block_tables: Optional[Tensor] = None  # [Bp, nbt] int32, null-padded
    cached_len: Optional[Tensor] = None    # [Bp] int32; None = cold prefill


class DECBatch(NamedTuple):
    """Decode/verify bucket.  ``tokens`` is ``[Bd]`` for plain one-token
    decode, or ``[Bd, Sd]`` for speculative verify chunks: each row carries
    its current token plus up to ``Sd - 1`` drafts, verified in one
    forward.  ``length`` gives each row's real chunk length (1 = plain
    decode row, 0 = padding row); trailing positions write to the null
    block."""
    tokens: Tensor                   # [Bd] or [Bd, Sd] int32
    pos: Tensor                      # [Bd] int32 start positions (= cache len)
    adapter: Tensor                  # [Bd] int32
    block_tables: Optional[Tensor] = None  # [Bd, nbt] int32
    length: Optional[Tensor] = None  # [Bd] int32 valid chunk lengths


class UnifiedBatch(NamedTuple):
    ft: Optional[FTBatch] = None
    pf: Optional[PFBatch] = None
    dec: Optional[DECBatch] = None


class ModelOut(NamedTuple):
    ft_loss_sum: Optional[Tensor]    # [Bf] f32 summed token CE (shifted)
    ft_tok_count: Optional[Tensor]   # [Bf] f32 valid target tokens
    ft_logits: Optional[Tensor]      # [Bf, Sf, V] (only if requested)
    pf_logits: Optional[Tensor]      # [Bp, V] logits at last valid position
    dec_logits: Optional[Tensor]     # [Bd, V]; [Bd, Sd, V] for verify chunks
    cache: Optional[dict]
    aux_loss: Tensor                 # scalar
