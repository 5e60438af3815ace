"""Mamba2 / SSD (state-space duality) mixer [arXiv:2405.21060].

Port of ``repro.models.mamba``.  The JAX package computes the mixer in
jnp under ``lax.scan``, with no Pallas kernel, so this is plain PyTorch on
every device: the same function, not a fallback.

Training and prefill use the chunked SSD algorithm (the intra-chunk
attention-like form plus the inter-chunk state recurrence, a Python loop
over chunks here); decode is the O(1) single-step recurrence.  Padding is
handled by forcing ``dt = 0`` on pad tokens, which makes the recurrence a
no-op (decay 1, update 0).  The rounding points are the JAX package's:
the intra-chunk matrix ``M`` and the ingest weights ``w_in`` are cast to
the activation dtype, the decay and ``dt`` stay fp32, and the state keeps
the dtype it was given.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.configs import ModelConfig


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                state: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d.  x: [B, S, C]; w: [K, C]; state: [B, K-1,
    C].  Returns (y [B, S, C], new_state [B, K-1, C]): the last ``K-1``
    inputs of ``x``, whatever they are (a padded row's state is its pad
    tail's, as in the JAX package)."""
    K = w.shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], K - 1, x.shape[-1]))
    xp = torch.cat([state.to(x.dtype), x], dim=1)                # [B, S+K-1, C]
    S = x.shape[1]
    y = sum(xp[:, i:i + S] * w[i].to(x.dtype) for i in range(K))
    y = y + b.to(x.dtype)
    new_state = xp[:, -(K - 1):] if K > 1 else state
    return y, new_state


def _chunk(h: torch.Tensor, xc: torch.Tensor, dtc: torch.Tensor,
           Bc: torch.Tensor, Cc: torch.Tensor, A: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One chunk of the scan: (h_new [B, nh, hd, ds], y [B, Q, nh, hd]).
    xc: [B, Q, nh, hd]; dtc: [B, Q, nh] fp32; Bc/Cc: [B, Q, nh, ds]."""
    Q = xc.shape[1]
    dA = dtc * A.float()                                         # [B,Q,nh]
    cs = torch.cumsum(dA, dim=1)                                 # inclusive
    total = cs[:, -1, :]                                         # [B,nh]
    # intra: M[t,s] = exp(cs_t - cs_s) * dt_s * (C_t . B_s), s <= t.  The
    # upper triangle is masked before the exp (the JAX body masks after):
    # the same values, and no inf there to poison the backward
    cb = torch.einsum("bqhd,bkhd->bhqk", Cc, Bc).float()
    cst = cs.transpose(1, 2)                                     # [B,nh,Q]
    delta = cst[:, :, :, None] - cst[:, :, None, :]              # [B,nh,q,k]
    causal = torch.ones((Q, Q), dtype=torch.bool,
                        device=xc.device).tril()
    M = (torch.exp(delta.masked_fill(~causal, float("-inf")))
         * dtc.transpose(1, 2)[:, :, None, :]) * cb
    y_c = torch.einsum("bhqk,bkhd->bqhd", M.to(xc.dtype), xc)
    # inter: y_t += C_t . (exp(cs_t) * h_start)
    w_out = torch.exp(cs).to(xc.dtype)                           # [B,Q,nh]
    y_c = y_c + torch.einsum("bqhd,bhpd->bqhp", Cc,
                             h.to(xc.dtype)) * w_out[..., None]
    # state update: h' = exp(total) h + sum_s exp(total - cs_s) dt_s B_s x_s
    w_in = (torch.exp(total[:, None, :] - cs) * dtc).to(xc.dtype)
    ingest = torch.einsum("bkhd,bkhp->bhpd", Bc * w_in[..., None], xc)
    h_new = h * torch.exp(total).to(h.dtype)[:, :, None, None] + ingest
    return h_new.to(h.dtype), y_c


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                h0: Optional[torch.Tensor] = None, remat: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.

    x:  [B, S, nh, hd]   inputs per head
    dt: [B, S, nh]       softplus'd step sizes (0 on pad tokens)
    A:  [nh]             negative per-head decay rates
    Bm/Cm: [B, S, nh, ds] input/output projections (groups pre-expanded)
    h0: [B, nh, hd, ds]  initial state (zeros of ``x``'s dtype if None)
    ``remat``: recompute each chunk in the backward
    (``torch.utils.checkpoint``, as the JAX body is ``jax.checkpoint``ed),
    so the ``[Q, Q]`` decay matrix is held for one chunk at a time there
    too.  Returns (y [B, S, nh, hd], h_final [B, nh, hd, ds]).
    """
    Bsz, S, nh, hd = x.shape
    ds = Bm.shape[-1]
    pad = (-S) % chunk
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        Bm = torch.nn.functional.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = torch.nn.functional.pad(Cm, (0, 0, 0, 0, 0, pad))
    dt = dt.float()
    h = (x.new_zeros((Bsz, nh, hd, ds)) if h0 is None else h0)
    ys = []
    for c0 in range(0, S + pad, chunk):
        sl = slice(c0, c0 + chunk)
        args = (h, x[:, sl], dt[:, sl], Bm[:, sl], Cm[:, sl], A)
        if remat and torch.is_grad_enabled():
            h, y_c = checkpoint(_chunk, *args, use_reentrant=False)
        else:
            h, y_c = _chunk(*args)
        ys.append(y_c)
    y = torch.cat(ys, dim=1)[:, :S]
    return y, h


def ssd_step(h: torch.Tensor, x_t: torch.Tensor, dt_t: torch.Tensor,
             A: torch.Tensor, B_t: torch.Tensor, C_t: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single decode step.  h: [B, nh, hd, ds]; x_t: [B, nh, hd]; dt_t: [B,
    nh]; B_t/C_t: [B, nh, ds].  Returns (y [B, nh, hd], h_new)."""
    dA = dt_t.float() * A.float()                                # [B,nh]
    decay = torch.exp(dA).to(h.dtype)[:, :, None, None]
    update = ((dt_t.to(x_t.dtype)[:, :, None] * x_t)[..., None]
              * B_t[:, :, None, :])
    h_new = h * decay + update
    y = torch.einsum("bhpd,bhd->bhp", h_new, C_t.to(h_new.dtype))
    return y, h_new


def split_zxbcdt(cfg: ModelConfig, zxbcdt: torch.Tensor):
    """Split a fused in-projection output along its last axis into (z, x,
    B, C, dt)."""
    s = cfg.ssm
    di, gds = cfg.d_inner, s.n_groups * s.d_state
    return torch.split(zxbcdt, [di, di, gds, gds, cfg.n_ssm_heads], dim=-1)


def expand_groups(t: torch.Tensor, nh: int) -> torch.Tensor:
    """[..., g, ds] -> [..., nh, ds] by repeating each group nh//g times."""
    return torch.repeat_interleave(t, nh // t.shape[-2], dim=-2)
