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
With grad mode on and fine-tune rows at the head of the stream (``n_ft``),
SMLM runs as ``SMLMFunction``, whose backward is the SMLM kernel (dX) and
``smlm_wgrad`` (dA, dB) over those rows; the BGMV decode tail stays a plain
launch without gradient, which is exact, since the loss reads only ft rows
and ft attention sees only ft keys.  Under a mesh the terms run split
(``lora_split``: shrink, an all-reduce over the ranks that hold d_in,
expand), and with grad mode on as ``SplitLoRAFunction``, whose backward is
the split entries again (``Gs`` and dX) and ``smlm_wgrad`` on the rank's
slices, with the collective held in both passes.

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
from repro_torch.kernels.bgmv import bgmv, bgmv_expand, bgmv_shrink
from repro_torch.kernels.smlm import SMLMFunction, smlm, smlm_expand, \
    smlm_shrink, smlm_wgrad_split


class LoraRoute(NamedTuple):
    """Per-forward routing of the stream, computed once and shared by every
    projection: the ft+pf head's per-tile ids/scales and the decode tail's
    per-token ids/scales.  The head's first ``n_ft`` tokens are fine-tune
    rows, the only ones that carry gradient."""
    n_head: int
    block_t: int
    tile_ids: torch.Tensor       # [n_head / block_t] int32, clipped
    tile_scale: torch.Tensor     # [n_head / block_t] f32, 0 = base only
    tail_ids: torch.Tensor       # [T - n_head] int32, clipped
    tail_scale: torch.Tensor     # [T - n_head] f32
    n_ft: int = 0


def route(ids: torch.Tensor, scale_t: Optional[torch.Tensor], n_slots: int,
          n_head: int, block_t: int, n_ft: int = 0) -> LoraRoute:
    """``ids``/``scale_t``: per-token [T]; ``n_head``: ft+pf tokens and
    ``n_ft``: the ft tokens among them, both multiples of ``block_t`` by the
    planner's contract."""
    if n_head % block_t or n_ft % block_t or n_ft > n_head:
        raise ValueError(f"the ft+pf head ({n_head} tokens, {n_ft} ft) is "
                         f"not a multiple of the planner tile "
                         f"block_t={block_t}")
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
        tail_scale=scale[n_head:].contiguous(), n_ft=n_ft)


def lora_apply(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
               rt: LoraRoute) -> torch.Tensor:
    """x: [T, d_in]; a: [n, d_in, r]; b: [n, r, d_out].  Returns the
    multi-LoRA term [T, d_out]."""
    x = x.contiguous()
    parts = []
    if rt.n_head:
        head = x[:rt.n_head]
        if rt.n_ft and torch.is_grad_enabled() and (
                head.requires_grad or a.requires_grad or b.requires_grad):
            parts.append(SMLMFunction.apply(head, a, b, rt.tile_ids,
                                            rt.tile_scale, rt.block_t,
                                            rt.n_ft))
        else:
            parts.append(smlm(head, a, b, rt.tile_ids, rt.tile_scale,
                              block_t=rt.block_t))
    if x.shape[0] > rt.n_head:
        parts.append(bgmv(x[rt.n_head:].detach(), a.detach(), b.detach(),
                          rt.tail_ids, rt.tail_scale))
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def lora_shrink(x: torch.Tensor, a: torch.Tensor,
                rt: LoraRoute) -> torch.Tensor:
    """The multi-LoRA term's scaled shrink alone, fp32 [T, r]: the head
    through ``smlm_shrink``, the decode tail through ``bgmv_shrink``.  Under
    a mesh, x and a hold one rank's slice of d_in, and the result is that
    slice's partial sum.  No gradient of its own: ``SplitLoRAFunction``
    differentiates it."""
    x = x.contiguous()
    parts = []
    if rt.n_head:
        parts.append(smlm_shrink(x[:rt.n_head], a, rt.tile_ids,
                                 rt.tile_scale, block_t=rt.block_t))
    if x.shape[0] > rt.n_head:
        parts.append(bgmv_shrink(x[rt.n_head:], a, rt.tail_ids,
                                 rt.tail_scale))
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def lora_expand(s: torch.Tensor, b: torch.Tensor,
                rt: LoraRoute) -> torch.Tensor:
    """``lora_shrink``'s summed fp32 [T, r] through ``b`` (a rank's slice of
    d_out under a mesh): [T, d_out] in b's dtype, the head through
    ``smlm_expand``, the tail through ``bgmv_expand``."""
    s = s.contiguous()
    parts = []
    if rt.n_head:
        parts.append(smlm_expand(s[:rt.n_head], b, rt.tile_ids,
                                 rt.tile_scale, block_t=rt.block_t))
    if s.shape[0] > rt.n_head:
        parts.append(bgmv_expand(s[rt.n_head:], b, rt.tail_ids,
                                 rt.tail_scale))
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _split_terms(x, rt, reduce, reduce_s, pairs):
    """The split terms' forward: every pair's shrink of ``x``, the shrinks
    summed in one ``reduce`` (in place) when ``reduce_s``, every pair's
    expand.  Returns (the terms, the summed shrinks)."""
    s = [lora_shrink(x, a, rt) for a, _ in pairs]
    if reduce_s:
        s = list(torch.split(reduce(torch.cat(s, dim=1)),
                             [t.shape[1] for t in s], dim=1))
    return [lora_expand(si, b, rt) for si, (_, b) in zip(s, pairs)], s


def reduce_gs(reduce, gs: torch.Tensor) -> torch.Tensor:
    """The backward's all-reduce of the ``Gs`` shrinks (a seam for the
    planted fault of the sharded train step's tests)."""
    return reduce(gs)


class SplitLoRAFunction(torch.autograd.Function):
    """The multi-LoRA terms of projections that share one input ``x`` under
    a mesh, with their gradient to x and to every pair's ``a`` and ``b``,
    the collective held in both passes.  ``x`` [T, d] is a rank's slice of
    d_in (its ``a`` the matching rows) or the whole input; ``b`` a rank's
    columns, or whole.

    Forward: per pair ``S = scale X A`` (``lora_shrink``), the shrinks
    summed over the ranks in one ``reduce`` when ``reduce_s`` (the slices
    of d_in), ``Y = S B`` (``lora_expand``); the summed ``S`` is kept.
    Backward, over the first ``n_ft`` tokens (the fine-tune rows, the only
    ones that carry gradient, as in ``SMLMFunction``): per pair ``Gs =
    scale dY B^T`` (``smlm_shrink`` with ``B^T``), summed in one ``reduce``
    for the pairs whose ``reduce_gs`` is set (the ranks read ``Y``
    differently, so each ``dY`` is a summand; a ``Y`` every rank reads
    alike has its whole ``dY`` on every rank already); ``dX = Gs A^T``
    (``smlm_expand`` with ``A^T``), summed over the pairs; ``dA = X^T Gs``,
    ``dB = S^T dY`` (``smlm_wgrad``, once a pair).  The prefill rows' dX is
    zero; the BGMV decode tail takes no gradient."""

    @staticmethod
    def forward(ctx, x, rt, reduce, reduce_s, reduce_gs, *ab):
        pairs = list(zip(ab[0::2], ab[1::2]))
        ys, s = _split_terms(x, rt, reduce, reduce_s, pairs)
        ctx.save_for_backward(x, *ab, *(si[:rt.n_ft] for si in s))
        ctx.rt, ctx.reduce, ctx.reduce_gs = rt, reduce, reduce_gs
        return tuple(ys)

    @staticmethod
    def backward(ctx, *dys):
        rt, k = ctx.rt, len(ctx.reduce_gs)
        x, *rest = ctx.saved_tensors
        a, b, s = rest[0:2 * k:2], rest[1:2 * k:2], rest[2 * k:]
        n_ft, bt = rt.n_ft, rt.block_t
        ids, scale = rt.tile_ids[:n_ft // bt], rt.tile_scale[:n_ft // bt]
        dy = [torch.zeros((n_ft, bi.shape[-1]), dtype=bi.dtype,
                          device=x.device) if d is None
              else d[:n_ft].contiguous() for d, bi in zip(dys, b)]
        gs = [smlm_shrink(d, bi.transpose(1, 2).contiguous(), ids, scale,
                          block_t=bt) for d, bi in zip(dy, b)]
        summed = [g for g, r in zip(gs, ctx.reduce_gs) if r]
        if summed:
            got = iter(torch.split(
                reduce_gs(ctx.reduce, torch.cat(summed, dim=1)),
                [g.shape[1] for g in summed], dim=1))
            gs = [next(got).contiguous() if r else g
                  for g, r in zip(gs, ctx.reduce_gs)]
        dx = None
        if ctx.needs_input_grad[0]:
            dx = torch.zeros_like(x)
            for g, ai in zip(gs, a):
                dx[:n_ft] += smlm_expand(g, ai.transpose(1, 2).contiguous(),
                                         ids, scale, block_t=bt)
        dab = []
        for i in range(k):
            dab += smlm_wgrad_split(x[:n_ft].contiguous(), dy[i], s[i],
                                    gs[i], ids, scale, block_t=bt,
                                    n_slots=a[i].shape[0])
        return (dx, None, None, None, None, *dab)


def split_carries_grad(x: torch.Tensor, pairs, rt: LoraRoute) -> bool:
    """Whether ``lora_split`` takes ``SplitLoRAFunction``: a gradient is to
    be carried and the stream has fine-tune rows."""
    return bool(rt.n_ft) and torch.is_grad_enabled() and (
        x.requires_grad or any(t.requires_grad for p in pairs for t in p))


def lora_split(x: torch.Tensor, pairs, rt: LoraRoute, reduce,
               reduce_s: bool, reduce_gs) -> list:
    """The split multi-LoRA terms [T, d_out_i] of the ``(a, b)`` ``pairs``
    sharing ``x``: ``reduce`` an in-place all-reduce over the ranks that
    hold d_in, ``reduce_s`` whether the shrinks are summed (x a slice of
    d_in), ``reduce_gs`` per pair whether the backward sums its ``Gs``
    (``SplitLoRAFunction``, taken when a gradient is to be carried and the
    stream has fine-tune rows; otherwise the plain split entries)."""
    if split_carries_grad(x, pairs, rt):
        return list(SplitLoRAFunction.apply(
            x, rt, reduce, reduce_s, tuple(reduce_gs),
            *(t for p in pairs for t in p)))
    return _split_terms(x, rt, reduce, reduce_s, pairs)[0]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    lengths: torch.Tensor, *, causal: bool = True,
                    window: int = 0, block_q: int = 128,
                    block_k: int = 128) -> torch.Tensor:
    """Flash attention (every cold prefill): q [B, S, h, hd] over k/v
    [B, T, g, hd], keys ``j < lengths[b]`` (and ``j <= i`` when causal, and
    ``i - j < window`` when ``window > 0``).  ``block_q``/``block_k`` are
    the Pallas kernel's tiles; the CUDA kernel picks its own, and the
    result does not depend on them."""
    del block_q, block_k
    return flash_attn.flash_attention(q, k, v, lengths, causal, window)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: torch.Tensor, *, window: int = 0,
                     block_k: int = 512) -> torch.Tensor:
    """Dense-row decode attention (one query per request over its cache
    row, linear or rolling).  ``block_k`` is the Pallas kernel's tile and
    does not change the result."""
    del block_k
    return decode_attn.decode_attention(q, k, v, pos, window=window)
