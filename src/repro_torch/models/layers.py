"""Shared layer math: RMSNorm, RoPE, masked GQA attention, SwiGLU.

Same contracts as ``repro.models.layers``: the attention mask is built from
explicit per-token positions, and a query row with no valid key is defined
as 0 (``layers.py:97-105`` of the JAX package).  The attention is the plain
full-scores form; it is the CPU path of the paged kernels' plain versions and
the cold-prefill prompt-local attention, which the JAX package also computes
outside any kernel.  ``scaled_dot_product_attention`` is not used: it gives
NaN on fully masked rows, and it is a library kernel.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    x32 = x.float()
    y = x32 * torch.rsqrt(x32.pow(2).mean(dim=-1, keepdim=True) + eps)
    return (y * w.float()).to(x.dtype)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding (half-split form).  x: [..., n_heads, hd]; pos
    broadcastable to x's leading dims (e.g. [B, S] for [B, S, h, hd])."""
    hd = x.shape[-1]
    half = hd // 2
    # float base ** float32 tensor: no host-to-device copy (which would
    # synchronise the stream) for the scalar
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = pos.float()[..., None, None] * freqs                 # [..., 1, half]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
           wd: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ wg.to(x.dtype)) * (x @ wu.to(x.dtype))) \
        @ wd.to(x.dtype)


def _build_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
                k_valid: torch.Tensor, causal: bool, window: int
                ) -> torch.Tensor:
    """[B, S, T] boolean mask from per-token positions."""
    m = k_valid[:, None, :]
    if causal:
        m = m & (k_pos[:, None, :] <= q_pos[:, :, None])
    if window > 0:
        m = m & (q_pos[:, :, None] - k_pos[:, None, :] < window)
    return m


def dec_cache_pos(pos: torch.Tensor, sc: int):
    """Per-row ``(k_pos [B, sc], k_valid [B, sc])`` of a dense cache row of
    ``sc`` slots (linear, or rolling once ``pos >= sc``) after the current
    token at ``pos`` was written: slot ``j`` holds the latest position
    ``<= pos`` congruent to ``j`` mod ``sc`` (``_dec_cache_pos`` of the JAX
    model)."""
    j = torch.arange(sc, device=pos.device)[None, :]
    p = pos.long()[:, None]
    k_pos = j + sc * torch.div(p - j, sc, rounding_mode="floor")
    return k_pos, j <= p


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              q_pos: torch.Tensor, k_pos: torch.Tensor,
              k_valid: torch.Tensor, causal: bool = True, window: int = 0,
              chunk: int = 0, scale: Optional[float] = None) -> torch.Tensor:
    """Generic GQA attention.  q: [B, S, h, hd]; k/v: [B, T, g, hd] with
    h % g == 0; q_pos: [B, S]; k_pos/k_valid: [B, T].  The chunked online-
    softmax path (``chunk > 0``) belongs to a later slice."""
    if chunk:
        raise NotImplementedError(
            "chunked attention (attn_chunk > 0) is not ported yet")
    B, S, h, hd = q.shape
    T, g = k.shape[1], k.shape[2]
    m = h // g
    scale = scale if scale is not None else hd ** -0.5
    qg = q.reshape(B, S, g, m, hd)
    mask = _build_mask(q_pos, k_pos, k_valid, causal, window)     # [B, S, T]
    scores = torch.einsum("bsgmd,btgd->bgmst", qg, k).float() * scale
    scores = scores.masked_fill(~mask[:, None, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bgmst,btgd->bsgmd", probs, v)
    # fully-masked queries (pad rows) are defined as 0 — matches the
    # online-softmax kernels, whose l stays 0 there
    live = mask.any(-1)[:, :, None, None, None]
    out = torch.where(live, out, torch.zeros((), dtype=out.dtype,
                                             device=out.device))
    return out.reshape(B, S, h, hd)
