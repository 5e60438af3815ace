"""Shared layer math: RMSNorm, RoPE, masked GQA attention, SwiGLU.

Same contracts as ``repro.models.layers``: the attention mask is built from
explicit per-token positions, and a query row with no valid key is defined
as 0 (``layers.py:97-105`` of the JAX package).  The attention is the plain
full-scores form; it is the CPU path of the paged kernels' plain versions and
the cold-prefill prompt-local attention, which the JAX package also computes
outside any kernel.  ``scaled_dot_product_attention`` is not used: it gives
NaN on fully masked rows, and it is a library kernel.  With ``chunk > 0``
the attention streams the key axis in chunks with an online softmax, and a
query longer than the chunk is cut into query blocks, each recomputed in
the backward (``torch.utils.checkpoint``, as ``jax.checkpoint`` in the JAX
package): the memory-bounded form of ft attention under autograd.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

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
    h % g == 0; q_pos: [B, S]; k_pos/k_valid: [B, T].  ``chunk > 0`` (below
    T) streams the key axis in blocks with an online softmax, and a query
    longer than ``chunk`` in query blocks recomputed in the backward."""
    B, S, h, hd = q.shape
    T, g = k.shape[1], k.shape[2]
    m = h // g
    scale = scale if scale is not None else hd ** -0.5
    qg = q.reshape(B, S, g, m, hd)
    if chunk and chunk < T:
        if S <= chunk:
            return _attention_chunked(qg, k, v, q_pos, k_pos, k_valid,
                                      causal, window, chunk,
                                      scale).reshape(B, S, h, hd)
        pad = (-S) % chunk
        if pad:
            qg = F.pad(qg, (0, 0, 0, 0, 0, 0, 0, pad))
            q_pos = F.pad(q_pos, (0, pad))
        outs = []
        for i in range(0, S + pad, chunk):
            args = (qg[:, i:i + chunk], k, v, q_pos[:, i:i + chunk], k_pos,
                    k_valid, causal, window, chunk, scale)
            # rematerialise per query block: the backward recomputes the
            # block instead of keeping its score tiles
            outs.append(checkpoint(_attention_chunked, *args,
                                   use_reentrant=False)
                        if torch.is_grad_enabled()
                        else _attention_chunked(*args))
        return torch.cat(outs, dim=1)[:, :S].reshape(B, S, h, hd)
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


def _attention_chunked(qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       q_pos: torch.Tensor, k_pos: torch.Tensor,
                       k_valid: torch.Tensor, causal: bool, window: int,
                       chunk: int, scale: float) -> torch.Tensor:
    """Online-softmax attention over key chunks of ``chunk``: qg [B, S, g,
    m, hd] -> [B, S, g, m, hd].  A query with no valid key gives 0."""
    B, S, g, m, hd = qg.shape
    T = k.shape[1]
    pad = (-T) % chunk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = F.pad(k_pos, (0, pad))
        k_valid = F.pad(k_valid, (0, pad))
    acc = torch.zeros((B, g, m, S, hd), dtype=torch.float32,
                      device=qg.device)
    m_run = torch.full((B, g, m, S), NEG_INF, dtype=torch.float32,
                       device=qg.device)
    l_run = torch.zeros((B, g, m, S), dtype=torch.float32, device=qg.device)
    for c in range(0, T + pad, chunk):
        kb, vb = k[:, c:c + chunk], v[:, c:c + chunk]
        mask = _build_mask(q_pos, k_pos[:, c:c + chunk],
                           k_valid[:, c:c + chunk], causal, window)
        s = torch.einsum("bsgmd,bcgd->bgmsc", qg, kb).float() * scale
        s = s.masked_fill(~mask[:, None, None], NEG_INF)
        m_new = torch.maximum(m_run, s.amax(dim=-1))
        # mask p explicitly: on a fully masked row m_new = NEG_INF and
        # exp(s - m_new) would be 1 on masked entries
        p = torch.where(mask[:, None, None], torch.exp(s - m_new[..., None]),
                        torch.zeros((), device=s.device))
        corr = torch.exp(torch.clamp(m_run - m_new, max=0.0))
        l_run = l_run * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bgmsc,bcgd->bgmsd", p.to(qg.dtype), vb).float()
        m_run = m_new
    out = acc / torch.clamp(l_run[..., None], min=1e-30)
    return out.permute(0, 3, 1, 2, 4).to(qg.dtype)
