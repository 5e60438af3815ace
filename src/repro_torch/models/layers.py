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

MLA (DeepSeek-V2) attends in the absorbed form of the JAX package
(``mla_attention``): scores and outputs against the compressed latent, K/V
never expanded; a long call (``chunk``) takes ``mla_attention_chunked``,
which expands K/V one key block at a time inside an online softmax.  Both
are plain PyTorch by design: the JAX package computes them in jnp, outside
any Pallas kernel.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

NEG_INF = -1e30


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5,
             ms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """RMSNorm over the last axis; ``ms`` [..., 1]: the fp32 mean of squares
    when ``x`` is a slice of the normed axis (taken over every slice)."""
    x32 = x.float()
    if ms is None:
        ms = x32.pow(2).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(ms + eps) * w.float()).to(x.dtype)


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


def _mla_chunk(qn: torch.Tensor, qp: torch.Tensor, qpos: torch.Tensor,
               ckv: torch.Tensor, kpe: torch.Tensor, k_pos: torch.Tensor,
               k_valid: torch.Tensor, w_uk: torch.Tensor, w_uv: torch.Tensor,
               causal: bool, window: int, chunk: int, scale: float
               ) -> torch.Tensor:
    """One query block of ``mla_attention_chunked``: qn [B, c, h, dn], qp
    [B, c, h, dr] over key blocks of ``chunk`` (already padded) ->
    [B, c, h, dv]."""
    B, S, h, _ = qn.shape
    acc = torch.zeros((B, h, S, w_uv.shape[-1]), dtype=torch.float32,
                      device=qn.device)
    m_run = torch.full((B, h, S), NEG_INF, dtype=torch.float32,
                       device=qn.device)
    l_run = torch.zeros((B, h, S), dtype=torch.float32, device=qn.device)
    for c in range(0, ckv.shape[1], chunk):
        cb, pb = ckv[:, c:c + chunk], kpe[:, c:c + chunk]
        kn = torch.einsum("btc,chd->bthd", cb, w_uk.to(cb.dtype))
        vv = torch.einsum("btc,chd->bthd", cb, w_uv.to(cb.dtype))
        s = torch.einsum("bshd,bthd->bhst", qn, kn).float()
        s = (s + torch.einsum("bshd,btd->bhst", qp, pb).float()) * scale
        mask = _build_mask(qpos, k_pos[:, c:c + chunk],
                           k_valid[:, c:c + chunk], causal, window)
        s = s.masked_fill(~mask[:, None], NEG_INF)
        m_new = torch.maximum(m_run, s.amax(dim=-1))
        p = torch.where(mask[:, None], torch.exp(s - m_new[..., None]),
                        torch.zeros((), device=s.device))
        corr = torch.exp(torch.clamp(m_run - m_new, max=0.0))
        l_run = l_run * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhst,bthd->bhsd", p.to(vv.dtype), vv).float()
        m_run = m_new
    out = acc / torch.clamp(l_run[..., None], min=1e-30)
    return out.transpose(1, 2).to(qn.dtype)


def mla_attention_chunked(q_nope: torch.Tensor, q_pe: torch.Tensor,
                          ckv: torch.Tensor, kpe: torch.Tensor,
                          w_uk: torch.Tensor, w_uv: torch.Tensor, *,
                          q_pos: torch.Tensor, k_pos: torch.Tensor,
                          k_valid: torch.Tensor, causal: bool = True,
                          window: int = 0, chunk: int = 1024
                          ) -> torch.Tensor:
    """Memory-bounded MLA for long prefill and training: K/V expanded from
    the latent one key block of ``chunk`` at a time inside an online
    softmax, query blocks of ``chunk`` each recomputed in the backward.
    Shapes as ``mla_attention``."""
    B, S, h, dn = q_nope.shape
    scale = (dn + q_pe.shape[-1]) ** -0.5
    padk = (-ckv.shape[1]) % chunk
    if padk:
        ckv = F.pad(ckv, (0, 0, 0, padk))
        kpe = F.pad(kpe, (0, 0, 0, padk))
        k_pos = F.pad(k_pos, (0, padk))
        k_valid = F.pad(k_valid, (0, padk))
    padq = (-S) % chunk
    if padq:
        q_nope = F.pad(q_nope, (0, 0, 0, 0, 0, padq))
        q_pe = F.pad(q_pe, (0, 0, 0, 0, 0, padq))
        q_pos = F.pad(q_pos, (0, padq))
    outs = []
    for i in range(0, S + padq, chunk):
        args = (q_nope[:, i:i + chunk], q_pe[:, i:i + chunk],
                q_pos[:, i:i + chunk], ckv, kpe, k_pos, k_valid, w_uk, w_uv,
                causal, window, chunk, scale)
        outs.append(checkpoint(_mla_chunk, *args, use_reentrant=False)
                    if torch.is_grad_enabled() else _mla_chunk(*args))
    return torch.cat(outs, dim=1)[:, :S]


def mla_attention(q_nope: torch.Tensor, q_pe: torch.Tensor,
                  ckv: torch.Tensor, kpe: torch.Tensor, w_uk: torch.Tensor,
                  w_uv: torch.Tensor, *, q_pos: torch.Tensor,
                  k_pos: torch.Tensor, k_valid: torch.Tensor,
                  causal: bool = True, window: int = 0, chunk: int = 0
                  ) -> torch.Tensor:
    """Absorbed-form MLA attention (DeepSeek-V2), the JAX package's
    ``layers.mla_attention``: q_nope [B, S, h, dn], q_pe [B, S, h, dr]
    (roped), ckv [B, T, c], kpe [B, T, dr] (roped), w_uk [c, h, dn], w_uv
    [c, h, dv] -> [B, S, h, dv], scale ``(dn + dr)^-1/2``.  ``q_lat`` and
    the score products are rounded to the input dtype before the fp32
    softmax, in the JAX order.  Unlike ``attention``, a query with no valid
    key is not zeroed (the JAX function does not either)."""
    B, S, h, dn = q_nope.shape
    T = ckv.shape[1]
    if chunk and (S > chunk or T > chunk):
        return mla_attention_chunked(q_nope, q_pe, ckv, kpe, w_uk, w_uv,
                                     q_pos=q_pos, k_pos=k_pos,
                                     k_valid=k_valid, causal=causal,
                                     window=window, chunk=chunk)
    scale = (dn + q_pe.shape[-1]) ** -0.5
    q_lat = torch.einsum("bshd,chd->bshc", q_nope, w_uk.to(q_nope.dtype))
    s = torch.einsum("bshc,btc->bhst", q_lat, ckv).float()
    s = (s + torch.einsum("bshd,btd->bhst", q_pe, kpe).float()) * scale
    mask = _build_mask(q_pos, k_pos, k_valid, causal, window)
    s = s.masked_fill(~mask[:, None], NEG_INF)
    p = torch.softmax(s, dim=-1).to(q_nope.dtype)
    o_lat = torch.einsum("bhst,btc->bshc", p, ckv)
    return torch.einsum("bshc,chd->bshd", o_lat, w_uv.to(q_nope.dtype))
