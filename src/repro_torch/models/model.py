"""The attention+FFN decoder on the paged and the dense-row KV layouts, with
the paper's unified computation flow: one joint projection per linear for
every request bucket (``core.lora.dense``: base product plus one multi-LoRA
kernel call per bucket), per-bucket attention, and per-bucket logits.

Port of the serving path of ``repro.models.model``.  Differences of form:

* the JAX ``lax.scan`` over periods becomes a loop over layers;
* the JAX functions return a new cache; here the cache is written in place
  (the paged pool by ``_paged_write_prompt`` / ``_paged_write_chunk``, the
  dense rows by ``_dense_write_prompt`` and a slot write, all index writes
  into the cache tensors) and ``unified_forward`` returns the same cache;
* the layout is the batch's: a bucket with block tables runs on the paged
  pool, one without on dense rows, as in the JAX model;
* every cold prefill (dense rows, and paged rows with ``cached_len=None``)
  attends through ``ops.flash_attention``, which the JAX model computes
  with plain ``L.attention`` (the same function);
* on CUDA tensors, flash, suffix prefill, decode (paged and dense) and
  verify attention are the hand-written kernels (``kernels.flash_attn``,
  ``kernels.prefill_attn``, ``kernels.decode_attn``,
  ``kernels.verify_attn``, ``kernels.splitk``); their plain versions run
  only for CPU tensors.  There is no backend switch: the paged
  decode/verify bucket takes the split-K kernels whenever
  ``kernels.autotune.choose`` gives more than one split for its shape, as
  the JAX ``splitk`` kernel modes do.

The ft bucket, sliding windows, dense-row verify chunks, MLA, Mamba, MoE and
cross-attention belong to later slices and raise here.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.lora import dense
from repro_torch.kernels import autotune, ops
from repro_torch.kernels.decode_attn import paged_decode_attention
from repro_torch.kernels.prefill_attn import paged_prefill_attention
from repro_torch.kernels.splitk import (paged_decode_attention_splitk,
                                        paged_verify_attention_splitk)
from repro_torch.kernels.verify_attn import paged_verify_attention
from repro_torch.models import layers as L
from repro_torch.models.configs import ModelConfig
from repro_torch.models.schema import check_supported
from repro_torch.models.stream import ModelOut, UnifiedBatch


# ---------------------------------------------------------------------------
# stream plan: bucket sizes, per-token adapter routing, split/merge
# ---------------------------------------------------------------------------

class _Plan:
    def __init__(self, cfg: ModelConfig, batch: UnifiedBatch,
                 lora_scale: Optional[torch.Tensor], block_t: int):
        if batch.ft is not None:
            raise NotImplementedError(
                "fine-tune/eval rows come with the training slice")
        pf, dec = batch.pf, batch.dec
        self.pf, self.dec = pf, dec
        self.Bp, self.Sp = tuple(pf.tokens.shape) if pf is not None else (0, 0)
        # decode bucket: [Bd] plain decode or [Bd, Sd] verify chunks
        if dec is not None:
            self.Bd = dec.tokens.shape[0]
            self.Sd = dec.tokens.shape[1] if dec.tokens.ndim == 2 else 1
        else:
            self.Bd, self.Sd = 0, 1
        self.sizes = [self.Bp * self.Sp, self.Bd * self.Sd]
        self.T = sum(self.sizes)
        ids = []
        if pf is not None:
            ids.append(torch.repeat_interleave(pf.adapter, self.Sp))
        if dec is not None:
            ids.append(torch.repeat_interleave(dec.adapter, self.Sd))
        self.ids = torch.cat(ids) if ids else None
        self.route = None
        if lora_scale is not None and self.ids is not None:
            n = lora_scale.shape[0]
            scale_t = lora_scale[self.ids.long().clamp(0, n - 1)]
            self.route = ops.route(self.ids, scale_t, n, self.sizes[0],
                                   block_t)
        if pf is not None:
            ar = torch.arange(self.Sp, dtype=torch.int32,
                              device=pf.tokens.device)
            self.pf_cached = pf.cached_len
            if pf.cached_len is not None:
                self.pf_pos = pf.cached_len[:, None] + ar[None, :]
            else:
                self.pf_pos = ar[None, :].expand(self.Bp, self.Sp)
        if dec is not None:
            if dec.block_tables is None and self.Sd > 1:
                raise NotImplementedError(
                    "verify chunks on dense rows: the engine runs "
                    "speculation on the paged layout only")
            # per-query positions of the (1 + k)-token chunk, and per-row
            # valid chunk lengths (trailing draft slots may be padding)
            self.dec_pos = dec.pos
            ard = torch.arange(self.Sd, dtype=torch.int32,
                               device=dec.pos.device)
            self.dec_qpos = dec.pos[:, None] + ard[None, :]
            self.dec_len = (dec.length if dec.length is not None
                            else torch.full_like(dec.pos, self.Sd))

    def split(self, x: torch.Tensor):
        """[T, ...] -> (xp [Bp, Sp, ...], xd [Bd, Sd, ...])"""
        t0 = self.sizes[0]
        rest = x.shape[1:]
        xp = x[:t0].reshape(self.Bp, self.Sp, *rest) if t0 else None
        xd = x[t0:].reshape(self.Bd, self.Sd, *rest) if self.Bd else None
        return xp, xd


def _merge_flat(plan: _Plan, xp, xd) -> torch.Tensor:
    parts = []
    if xp is not None:
        parts.append(xp.reshape(plan.sizes[0], -1))
    if xd is not None:
        parts.append(xd.reshape(plan.sizes[1], -1))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)


# ---------------------------------------------------------------------------
# dense rows: per layer [n_rows, sc, g, hd], one row per resident request.
# Prefill writes rows [Bd, Bd + Bp) (Bd: this tick's decode-bucket size);
# decode updates rows [0, Bd) in place
# ---------------------------------------------------------------------------

def cache_seq_len(cfg: ModelConfig, s_max: int) -> int:
    w = cfg.sliding_window
    return min(s_max, w) if w > 0 else s_max


def init_cache(cfg: ModelConfig, n_rows: int, s_max: int,
               device: torch.device, dtype: torch.dtype) -> Dict:
    """``{"k": [L, n_rows, sc, g, hd], "v": ...}``; ``cache["k"][l]`` is
    layer ``l``'s rows (the JAX layout ``[n_periods, n_rows, sc, g, hd]``
    of an attention-only pattern, period axis unrolled)."""
    check_supported(cfg)
    shape = (cfg.n_layers, n_rows, cache_seq_len(cfg, s_max),
             cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, device=device, dtype=dtype),
            "v": torch.zeros(shape, device=device, dtype=dtype)}


def _dense_write_prompt(rows: torch.Tensor, xh: torch.Tensor,
                        r0: int) -> None:
    """In place: prefill rows ``[Bp, Sp, ...]`` land in cache rows
    ``[r0, r0 + Bp)`` at positions ``:Sp``.  A bucket longer than the row
    (``Sp > sc``) takes the rolling write of the JAX model: the last ``sc``
    positions at slots ``p % sc``, so its padding tail overwrites the head
    of the prompt (ROADMAP Queue 3)."""
    Bp, Sp = xh.shape[:2]
    sc = rows.shape[1]
    if Sp <= sc:
        rows[r0:r0 + Bp, :Sp] = xh.to(rows.dtype)
    else:
        sl = torch.arange(Sp - sc, Sp, device=xh.device) % sc
        rows[r0:r0 + Bp, sl] = xh[:, -sc:].to(rows.dtype)


# ---------------------------------------------------------------------------
# paged KV pool: per layer [n_blocks, block_size, g, hd]; block 0 is the
# reserved null block that absorbs padding writes (masked on read)
# ---------------------------------------------------------------------------

def init_paged_cache(cfg: ModelConfig, n_blocks: int, block_size: int,
                     device: torch.device, dtype: torch.dtype) -> Dict:
    """``{"k": [L, n_blocks, bs, g, hd], "v": ...}``; ``cache["k"][l]`` is
    layer ``l``'s contiguous pool."""
    check_supported(cfg)
    shape = (cfg.n_layers, n_blocks, block_size, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, device=device, dtype=dtype),
            "v": torch.zeros(shape, device=device, dtype=dtype)}


def _paged_write_prompt(pool: torch.Tensor, xh: torch.Tensor,
                        tables: torch.Tensor) -> None:
    """In place: scatter prefill rows ``[Bp, Sp, ...]`` into pool blocks via
    tables ``[Bp, nbt]``; positions beyond ``nbt * block_size`` are
    dropped (padding past the context limit)."""
    bs = pool.shape[1]
    Bp, Sp = xh.shape[:2]
    nbp = min(-(-Sp // bs), tables.shape[1])
    Lp = nbp * bs
    if Sp < Lp:
        xh = F.pad(xh, (0, 0) * (xh.ndim - 2) + (0, Lp - Sp))
    else:
        xh = xh[:, :Lp]
    xb = xh.reshape(Bp, nbp, bs, *xh.shape[2:])
    tbl = tables[:, :nbp].long().clamp(min=0)
    pool[tbl] = xb.to(pool.dtype)


def _paged_write_chunk(pool: torch.Tensor, xh: torch.Tensor,
                       tables: torch.Tensor, pos: torch.Tensor,
                       length: torch.Tensor) -> None:
    """In place: row ``b``'s token ``j`` lands at position ``pos[b] + j``;
    positions at or beyond ``length[b]`` go to the null block."""
    bs = pool.shape[1]
    Bd, Sd = xh.shape[:2]
    tbl = tables.long().clamp(min=0)
    j = torch.arange(Sd, device=xh.device)[None, :]
    p = pos.long()[:, None] + j                                   # [Bd, Sd]
    valid = j < length.long()[:, None]
    bi = (p // bs).clamp(0, tbl.shape[1] - 1)
    bid = torch.where(valid, torch.gather(tbl, 1, bi),
                      torch.zeros((), dtype=torch.long, device=xh.device))
    flat = xh.reshape(Bd * Sd, *xh.shape[2:])
    pool[bid.reshape(-1), (p % bs).reshape(-1)] = flat.to(pool.dtype)


# ---------------------------------------------------------------------------
# attention and FFN sublayers
# ---------------------------------------------------------------------------

def _rope_heads(x: torch.Tensor, pos: torch.Tensor, n: int,
                theta: float) -> torch.Tensor:
    """[B, S, n*hd] -> rope -> [B, S, n, hd]"""
    B, S = x.shape[:2]
    return L.rope(x.reshape(B, S, n, -1), pos, theta)


def _attn_apply(cfg: ModelConfig, p: Dict, lr: Dict, plan: _Plan,
                x: torch.Tensor, k_pool: torch.Tensor,
                v_pool: torch.Tensor) -> torch.Tensor:
    """``k_pool``/``v_pool``: the layer's paged pool ``[n_blocks, bs, g,
    hd]`` or dense rows ``[n_rows, sc, g, hd]``, as the buckets' tables
    say."""
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    xn = L.rms_norm(x, p["ln1"], cfg.rms_eps)

    def dn(name, bias=None):
        return dense(xn, p[name], p.get(bias) if bias else None,
                     lr.get(name), plan.route)

    q, k, v = dn("wq", "bq"), dn("wk", "bk"), dn("wv", "bv")
    qp, qd = plan.split(q)
    kp, kd = plan.split(k)
    vp, vd = plan.split(v)
    outs = [None, None]
    if qp is not None:           # prefill: causal + cache write
        pf = plan.pf
        qh = _rope_heads(qp, plan.pf_pos, h, cfg.rope_theta)
        kh = _rope_heads(kp, plan.pf_pos, kv, cfg.rope_theta)
        vh = vp.reshape(plan.Bp, plan.Sp, kv, hd)
        if pf.block_tables is not None and plan.pf_cached is not None:
            # suffix-only prefill: write the suffix K/V at its offset (all
            # writes land at positions >= cached_len, never in a shared
            # prefix block), then attend over the pool so the cached prefix
            # is read instead of recomputed
            _paged_write_chunk(k_pool, kh, pf.block_tables, plan.pf_cached,
                               pf.length)
            _paged_write_chunk(v_pool, vh, pf.block_tables, plan.pf_cached,
                               pf.length)
            outs[0] = paged_prefill_attention(
                qh, k_pool, v_pool, pf.block_tables, plan.pf_cached,
                pf.length)
        else:
            # cold prefill: prompt-local causal attention over the bucket's
            # own K/V (flash attention), then into the blocks or the rows
            outs[0] = ops.flash_attention(qh, kh, vh, pf.length,
                                          causal=True)
            if pf.block_tables is not None:
                _paged_write_prompt(k_pool, kh, pf.block_tables)
                _paged_write_prompt(v_pool, vh, pf.block_tables)
            else:
                _dense_write_prompt(k_pool, kh, plan.Bd)
                _dense_write_prompt(v_pool, vh, plan.Bd)
    if qd is not None and plan.dec.block_tables is None:   # dense decode
        qh = _rope_heads(qd, plan.dec_qpos, h, cfg.rope_theta)
        kh = _rope_heads(kd, plan.dec_qpos, kv, cfg.rope_theta)
        rows = torch.arange(plan.Bd, device=x.device)
        slot = plan.dec_pos.long() % k_pool.shape[1]
        k_pool[rows, slot] = kh[:, 0].to(k_pool.dtype)
        v_pool[rows, slot] = vd.reshape(plan.Bd, kv, hd).to(v_pool.dtype)
        outs[1] = ops.decode_attention(qh[:, 0].contiguous(),
                                       k_pool[:plan.Bd], v_pool[:plan.Bd],
                                       plan.dec_pos)[:, None]
    elif qd is not None:         # paged decode / verify: (1 + k)-token chunk
        dec, Sd, ns = plan.dec, plan.Sd, plan.num_splits
        tbl, dpos, dlen = dec.block_tables, plan.dec_pos, plan.dec_len
        qh = _rope_heads(qd, plan.dec_qpos, h, cfg.rope_theta)
        kh = _rope_heads(kd, plan.dec_qpos, kv, cfg.rope_theta)
        vh = vd.reshape(plan.Bd, Sd, kv, hd)
        _paged_write_chunk(k_pool, kh, tbl, dpos, dlen)
        _paged_write_chunk(v_pool, vh, tbl, dpos, dlen)
        # the shape decides: one split walks the table in one thread block
        # per (request, KV head); more split it and merge (flash decoding)
        if Sd == 1 and ns == 1:
            o = paged_decode_attention(qh[:, 0].contiguous(), k_pool, v_pool,
                                       tbl, dpos)[:, None]
        elif Sd == 1:
            o = paged_decode_attention_splitk(
                qh[:, 0].contiguous(), k_pool, v_pool, tbl, dpos,
                num_splits=ns, lens=dlen)[:, None]
        elif ns == 1:
            o = paged_verify_attention(qh.contiguous(), k_pool, v_pool, tbl,
                                       dpos, dlen)
        else:
            o = paged_verify_attention_splitk(qh.contiguous(), k_pool,
                                              v_pool, tbl, dpos, dlen,
                                              num_splits=ns)
        outs[1] = o
    out = _merge_flat(plan, *outs)
    return x + dense(out, p["wo"], None, lr.get("wo"), plan.route)


def _ffn_apply(cfg: ModelConfig, p: Dict, lr: Dict, plan: _Plan,
               x: torch.Tensor) -> torch.Tensor:
    xn = L.rms_norm(x, p["ln2"], cfg.rms_eps)
    g = dense(xn, p["wg"], None, lr.get("wg"), plan.route)
    u = dense(xn, p["wu"], None, lr.get("wu"), plan.route)
    return x + dense(F.silu(g) * u, p["wd"], None, lr.get("wd"), plan.route)


# ---------------------------------------------------------------------------
# unified forward (Algorithm 1, serving buckets)
# ---------------------------------------------------------------------------

def unified_forward(cfg: ModelConfig, params: Dict, batch: UnifiedBatch,
                    cache: Optional[Dict] = None, *,
                    loras: Optional[Dict] = None,
                    lora_scale: Optional[torch.Tensor] = None,
                    block_t: int, attn_chunk: int = 0) -> ModelOut:
    """One joint forward over the prefill and decode buckets.  ``block_t``
    is the flow planner's SMLM tile (``FlowConfig.block_t``).  The paged
    ``cache`` is updated in place and returned in ``ModelOut.cache``."""
    if attn_chunk:
        raise NotImplementedError("attn_chunk > 0 is not ported yet")
    check_supported(cfg)
    plan = _Plan(cfg, batch, lora_scale, block_t)
    if cache is None:
        raise ValueError("prefill/decode buckets require a cache")
    if plan.Bd and batch.dec.block_tables is not None:
        autotune.load_card_table(cache["k"].device)   # once, on a card
        # one split choice per forward, keyed on the kernels' own grid: one
        # thread block per (request, KV head), where the JAX model counts a
        # TPU grid cell per query head (h/g times more)
        plan.num_splits = autotune.choose(
            cfg.hd, cache["k"].shape[2], batch.dec.block_tables.shape[1],
            plan.Bd * cfg.n_kv_heads,
            lanes=autotune.effective_lanes(cache["k"].device)).num_splits
    toks = []
    if batch.pf is not None:
        toks.append(batch.pf.tokens.reshape(-1))
    if batch.dec is not None:
        toks.append(batch.dec.tokens.reshape(-1))
    x = params["embed"][torch.cat(toks).long()]                    # [T, d]

    lora_layers = (loras["layers"] if loras is not None
                   else [{} for _ in range(cfg.n_layers)])
    for li, (p, lr) in enumerate(zip(params["layers"], lora_layers)):
        x = _attn_apply(cfg, p, lr, plan, x, cache["k"][li], cache["v"][li])
        x = _ffn_apply(cfg, p, lr, plan, x)

    x = L.rms_norm(x, params["final_norm"], cfg.rms_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    xp, xd = plan.split(x)
    pf_logits = dec_logits = None
    if xd is not None:
        # [Bd, V] for plain decode; [Bd, Sd, V] for verify chunks (one
        # next-token distribution per chunk position, the acceptance oracle)
        dec_logits = xd[:, 0] @ head if plan.Sd == 1 else xd @ head
    if xp is not None:
        last = (batch.pf.length.long() - 1).clamp(min=0)
        pf_logits = xp[torch.arange(plan.Bp, device=x.device), last] @ head
    return ModelOut(ft_loss_sum=None, ft_tok_count=None, ft_logits=None,
                    pf_logits=pf_logits, dec_logits=dec_logits, cache=cache,
                    aux_loss=torch.zeros((), device=x.device))
