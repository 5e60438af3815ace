"""Kernel entry points with the JAX package's ``repro.kernels.ops``
signatures: the multi-LoRA dispatch over the unified token stream, with the
semantics of ``repro.core.lora.lora_apply_ref`` (exact per token), and the
dense attention kernels (``flash_attention``, ``decode_attention``).

The stream is ``[ft rows | pf rows | dec rows]``.  The flow planner pads
every ft/pf row to a multiple of ``FlowConfig.block_t``, so that head is
adapter-uniform per ``block_t`` tile and goes through SMLM at exactly that
tile — the planner's tile is passed down, never a default of the kernel's
own.  The decode bucket always goes through BGMV, split by bucket rather
than by ``T % block_t``, so mixed-adapter decode rows keep per-token ids.
Out-of-range ids (padding rows carry -1) get scale 0 and are clipped.

This avoids two faults of the JAX dispatch ``repro.kernels.ops.smlm``: its
default ``block_t=128`` straddles 8-token planner segments of different
adapters, and a decode tail with ``T % block_t == 0`` collapses its mixed
adapters to one per tile.  The kernels mask their own ragged ``d_out`` edge,
so no shape falls back to a plain version on the card.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import decode_attn, flash_attn
from repro_torch.kernels.bgmv import bgmv
from repro_torch.kernels.smlm import smlm


class LoraRoute(NamedTuple):
    """Per-forward routing of the stream, computed once and shared by every
    projection: the ft+pf head's per-tile ids/scales and the decode tail's
    per-token ids/scales."""
    n_head: int
    block_t: int
    tile_ids: torch.Tensor       # [n_head / block_t] int32, clipped
    tile_scale: torch.Tensor     # [n_head / block_t] f32, 0 = base only
    tail_ids: torch.Tensor       # [T - n_head] int32, clipped
    tail_scale: torch.Tensor     # [T - n_head] f32


def route(ids: torch.Tensor, scale_t: Optional[torch.Tensor], n_slots: int,
          n_head: int, block_t: int) -> LoraRoute:
    """``ids``/``scale_t``: per-token [T]; ``n_head``: ft+pf tokens, a
    multiple of ``block_t`` by the planner's contract."""
    if n_head % block_t:
        raise ValueError(f"the ft+pf head ({n_head} tokens) is not a "
                         f"multiple of the planner tile block_t={block_t}")
    valid = (ids >= 0) & (ids < n_slots)
    if scale_t is None:
        scale = valid.float()
    else:
        scale = torch.where(valid, scale_t.float(),
                            torch.zeros((), device=ids.device))
    ids_c = ids.clamp(0, n_slots - 1).to(torch.int32)
    return LoraRoute(
        n_head=n_head, block_t=block_t,
        tile_ids=ids_c[:n_head:block_t].contiguous(),
        tile_scale=scale[:n_head:block_t].contiguous(),
        tail_ids=ids_c[n_head:].contiguous(),
        tail_scale=scale[n_head:].contiguous())


def lora_apply(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
               rt: LoraRoute) -> torch.Tensor:
    """x: [T, d_in]; a: [n, d_in, r]; b: [n, r, d_out].  Returns the
    multi-LoRA term [T, d_out]."""
    x = x.contiguous()
    parts = []
    if rt.n_head:
        parts.append(smlm(x[:rt.n_head], a, b, rt.tile_ids, rt.tile_scale,
                          block_t=rt.block_t))
    if x.shape[0] > rt.n_head:
        parts.append(bgmv(x[rt.n_head:], a, b, rt.tail_ids, rt.tail_scale))
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    lengths: torch.Tensor, *, causal: bool = True,
                    block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """Flash attention (every cold prefill): q [B, S, h, hd] over k/v
    [B, T, g, hd], keys ``j < lengths[b]`` (and ``j <= i`` when causal).
    ``block_q``/``block_k`` are the Pallas kernel's tiles; the CUDA kernel
    picks its own, and the result does not depend on them."""
    del block_q, block_k
    return flash_attn.flash_attention(q, k, v, lengths, causal)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: torch.Tensor, *, window: int = 0,
                     block_k: int = 512) -> torch.Tensor:
    """Dense-row decode attention (one query per request over its cache
    row, linear or rolling).  ``block_k`` is the Pallas kernel's tile and
    does not change the result."""
    del block_k
    return decode_attn.decode_attention(q, k, v, pos, window=window)
