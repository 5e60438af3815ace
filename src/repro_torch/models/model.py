"""The decoder (GQA, MLA or Mamba2 mixers; dense, MoE or no FFN) on the paged
and the dense-row KV layouts, with the paper's unified computation flow:
one joint projection per linear for every request bucket
(``core.lora.dense``: base product plus one multi-LoRA kernel call per
bucket), per-bucket attention, and per-bucket logits.

Port of the attention, Mamba2 and FFN / MoE paths of ``repro.models.model``,
fine-tune bucket and int8 weight-only serving included.  Differences of form:

* the JAX ``lax.scan`` over periods becomes a loop over periods
  (``_run_periods``); with ``remat`` each period runs under
  ``torch.utils.checkpoint`` where JAX's scan body is ``jax.checkpoint``ed,
  its serving rows' Mamba decode step run once (``_Tape``), and JAX's
  ``act_constraint`` is the train step's sequence-sharded carry
  (``distributed.sharding.SeqShard``);
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
  the JAX ``splitk`` kernel modes do;
* fine-tune/eval rows (the ft bucket, first in the stream) attend causally
  over their own keys through the plain ``layers.attention`` under
  autograd, as the JAX model does; the prefill and decode buckets attend on
  detached inputs (their kernels have no backward), which prunes exactly
  what XLA prunes: the loss reads only ft rows and ft attention sees only
  ft keys, so those rows' gradients are zero.  For the same reason the
  K/V written into the persistent cache is detached, so the pool never
  joins a graph that would outlive the tick.  ``attn_chunk`` reaches the
  ft attention (the chunked online softmax of ``layers.attention``); the
  kernels of the other buckets already stream their keys, compute the same
  function and ignore it;
* a MoE layer's FFN is ``moe.moe_apply`` (only the routed experts'
  products) plus the shared expert through ``dense``; the router aux loss
  of every MoE layer over the whole stream is summed into
  ``ModelOut.aux_loss``, as in the JAX model.  Its value is the JAX
  model's; its gradient reaches the bank through the ft rows only, since
  the serving rows carry none here (in the JAX model the serving rows'
  router probabilities also feed it back);
* int8 weights (``models.quant``) dequantize to the dtype of
  ``final_norm``, the params' float dtype (the JAX model takes
  ``cfg.dtype``);
* an MLA layer (``cfg.mla``, ``_mla_apply``) caches the compressed latent
  ``ckv`` [.., c] and the shared roped key ``kpe`` [.., dr] in place of
  per-head K/V, and attends in the absorbed form of the JAX model
  (``layers.mla_attention``, plain PyTorch on every device: the JAX model
  has no Pallas kernel for it), over the bucket's own latent at a cold
  prefill and over the gathered view of its blocks (``_paged_view``,
  ``_paged_chunk_mask``) or its dense row otherwise.  ``attn_chunk``
  reaches its ft and prefill buckets, as in the JAX model; it never takes
  split-K;
* a Mamba2 layer (``_mamba_apply``) runs the SSD mixer of
  ``models.mamba`` (plain PyTorch on every device: the JAX model computes
  it in jnp, outside Pallas) between its LoRA projections ``in_z`` /
  ``in_x`` / ``out_proj`` (SMLM and BGMV through ``dense``), and keeps
  per-request state rows, not blocks;
* a cross-attention layer (``_cross_apply``, after the self-attention
  sublayer as in the JAX model) attends non-causally over its bucket's
  ``aux_embed`` projected through ``xwk`` / ``xwv`` (ft and prefill) or
  over the request's cached ``xk`` / ``xv`` row (decode and verify), in
  plain PyTorch on every device: the JAX model computes it in jnp, outside
  Pallas.  Its output is gated by ``tanh(xgate)``.  A model with an
  encoder (``whisper-base``) first replaces the ft and prefill buckets'
  ``aux_embed`` by ``encoder_forward``'s output (bidirectional, LoRA-free,
  plain PyTorch).  A cross model given an ft or prefill bucket without
  ``aux_embed`` raises a ``ValueError`` (the JAX model fails on ``None``).
* under an ambient mesh (``distributed.sharding.mesh_context``, which
  ``core.unified.make_forward_step(..., mesh=)`` sets), ``unified_forward``
  is ``_sharded_forward``: explicit SPMD on this rank's shards, where the
  JAX model is one program that GSPMD partitions (the same function:
  logits, ft losses and aux loss come back whole on every rank).  The two
  paths share the embedding lookup (``_embed``) and the head and loss
  (``_outputs``), whose collectives are the identity on one device, and
  every sublayer: GQA and MLA (windowed too), Mamba2, cross-attention and
  the encoder take the ``mesh`` and run their heads column- and
  row-parallel, or whole on every rank where a head count does not divide
  the model axis (``_Heads``; a Mamba2 mixer's SSM heads likewise).  MLA's
  latent rows (rolling rows of W slots under a window) are cut by slots
  over "model", so its decode is flash decoding over the ranks
  (``_mla_decode_sharded``: ``mla_partials`` on each rank, one
  all-to-all, split-K's merge kernel).  Mamba2's gated norm sums its
  squares over the ranks' d_inner slices (``gated_sum_sq``).
  GQA's ``k``/``v`` and the cross ``xk``/``xv`` rows are cut as
  ``distributed.sharding.kv_layout`` says under the step's
  ``cache_strategy``: by the KV heads; by the head dim, whose decode sums
  the partial scores in one all-reduce (``_hd_decode``, plain PyTorch);
  or by the slots, whose decode is flash decoding over the ranks with
  split-K's partial and merge kernels (``_seq_decode``).  With a gradient
  (``core.unified.make_grad_step(..., mesh=)``; every family but MoE and
  MLA, which ``check_shardable`` refuses) the same forward runs under
  autograd: its collectives in their ``*_grad`` forms, which sum a
  gradient over "model" only where the ranks read a tensor differently
  (``core.lora.dense_col``'s ``read``, ``_read``, ``_ssm_reads``; the
  gated norm's sum, ``gated_sum_sq``), and under ``fsdp_tp`` each layer's
  weights stay cut over "data" (``sharding.FSDPWeight``; an int8 leaf as
  its payload and scales).  The cross sources and the encoder carry no
  gradient: they are not trained.

The cache is a dict of named leaves (``cache_leaves``): ``k``/``v`` for
GQA, ``ckv``/``kpe`` for MLA, each ``[L_attn, ...]`` over the attention
layers, the Mamba state rows ``h`` / ``conv_x`` / ``conv_bc`` (``STATE_KEYS``),
each ``[L_mamba, n_rows, ...]`` over the Mamba layers, and the
cross-attention rows ``xk`` / ``xv`` (``STATE_KEYS`` too), each
``[L_cross, n_rows, F, g, hd]`` over the cross layers; ``layer_cache``
gives each layer its dict of views.  Dense-row verify chunks raise here.

A sliding window (``cfg.sliding_window`` = W > 0, dense rows only: the paged
pool refuses it, as in the JAX model) reaches the self-attention of every
family as in the JAX model: ft rows and cold prefill attend with ``window=W``
(GQA's cold prefill through the windowed flash kernel, MLA's through
``layers.mla_attention``), and the row has ``cache_seq_len`` = min(s_max, W)
slots, so decode attends with ``window=0`` over the rolling row, where the
slot positions alone keep each query to its last W keys.  Suffix prefill
(paged only), cross attention and the encoder stay unwindowed.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.lora import dense, dense_col, dense_row
from repro_torch.distributed import sharding as SH
from repro_torch.kernels import autotune, ops
from repro_torch.kernels.decode_attn import paged_decode_attention
from repro_torch.kernels.prefill_attn import paged_prefill_attention
from repro_torch.kernels.splitk import (lse_merge,
                                        paged_decode_attention_splitk,
                                        paged_verify_attention_splitk,
                                        splitk_partials)
from repro_torch.kernels.verify_attn import paged_verify_attention
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models.configs import ModelConfig
from repro_torch.models import quant
from repro_torch.models.moe import EXPERT_STACKS, moe_apply
from repro_torch.models.moe_dist import moe_apply_auto
from repro_torch.models.schema import check_supported, cross_len, \
    encoder_shapes, is_moe
from repro_torch.models.stream import ModelOut, UnifiedBatch
from repro_torch.training.optimizer import tree_leaves


# ---------------------------------------------------------------------------
# stream plan: bucket sizes, per-token adapter routing, split/merge
# ---------------------------------------------------------------------------

class _Plan:
    def __init__(self, cfg: ModelConfig, batch: UnifiedBatch,
                 lora_scale: Optional[torch.Tensor], block_t: int):
        ft, pf, dec = batch.ft, batch.pf, batch.dec
        self.ft, self.pf, self.dec = ft, pf, dec
        self.Bf, self.Sf = tuple(ft.tokens.shape) if ft is not None else (0, 0)
        self.Bp, self.Sp = tuple(pf.tokens.shape) if pf is not None else (0, 0)
        # decode bucket: [Bd] plain decode or [Bd, Sd] verify chunks
        if dec is not None:
            self.Bd = dec.tokens.shape[0]
            self.Sd = dec.tokens.shape[1] if dec.tokens.ndim == 2 else 1
        else:
            self.Bd, self.Sd = 0, 1
        self.sizes = [self.Bf * self.Sf, self.Bp * self.Sp, self.Bd * self.Sd]
        self._heads: Dict[tuple, "_Heads"] = {}
        # the running period's ``_Tape`` under remat (``_run_periods``)
        self.tape: Optional["_Tape"] = None
        self.T = sum(self.sizes)
        ids = []
        if ft is not None:
            ids.append(torch.repeat_interleave(ft.adapter, self.Sf))
        if pf is not None:
            ids.append(torch.repeat_interleave(pf.adapter, self.Sp))
        if dec is not None:
            ids.append(torch.repeat_interleave(dec.adapter, self.Sd))
        self.ids = torch.cat(ids) if ids else None
        self.route = None
        if lora_scale is not None and self.ids is not None:
            n = lora_scale.shape[0]
            scale_t = lora_scale[self.ids.long().clamp(0, n - 1)]
            self.route = ops.route(self.ids, scale_t, n,
                                   self.sizes[0] + self.sizes[1], block_t,
                                   n_ft=self.sizes[0])
        if ft is not None:
            self.ft_pos = torch.arange(
                self.Sf, dtype=torch.int32,
                device=ft.tokens.device)[None, :].expand(self.Bf, self.Sf)
            self.ft_valid = ft.mask
        if pf is not None:
            ar = torch.arange(self.Sp, dtype=torch.int32,
                              device=pf.tokens.device)
            self.pf_cached = pf.cached_len
            self.pf_valid = ar[None, :] < pf.length[:, None]
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

    def heads(self, cfg: ModelConfig, mesh, h: int, kv: int) -> "_Heads":
        """This rank's ``_Heads`` for ``h`` query and ``kv`` KV heads (made
        once a forward)."""
        if (h, kv) not in self._heads:
            self._heads[h, kv] = _Heads(cfg, mesh, h, kv, self.ids.device
                                        if self.ids is not None else None)
        return self._heads[h, kv]

    def split(self, x: torch.Tensor):
        """[T, ...] -> (xf [Bf, Sf, ...], xp [Bp, Sp, ...], xd [Bd, Sd,
        ...])"""
        t0, t1, _ = self.sizes
        rest = x.shape[1:]
        xf = x[:t0].reshape(self.Bf, self.Sf, *rest) if t0 else None
        xp = x[t0:t0 + t1].reshape(self.Bp, self.Sp, *rest) if t1 else None
        xd = (x[t0 + t1:].reshape(self.Bd, self.Sd, *rest) if self.Bd
              else None)
        return xf, xp, xd


def _merge_flat(plan: _Plan, xf, xp, xd) -> torch.Tensor:
    parts = [xb.reshape(n, -1) for xb, n in zip((xf, xp, xd), plan.sizes)
             if xb is not None]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)


# ---------------------------------------------------------------------------
# the cache: named leaves, each [L, n_rows, sc, ...] (dense rows, one row per
# resident request) or [L, n_blocks, bs, ...] (the paged pool).  Dense
# prefill writes rows [Bd, Bd + Bp) (Bd: this tick's decode-bucket size);
# decode updates rows [0, Bd) in place
# ---------------------------------------------------------------------------

def cache_seq_len(cfg: ModelConfig, s_max: int) -> int:
    w = cfg.sliding_window
    return min(s_max, w) if w > 0 else s_max


# cache leaves that stay per-request rows in the paged layout too (the JAX
# model's STATE_KEYS)
STATE_KEYS = frozenset({"h", "conv_x", "conv_bc", "xk", "xv"})


def _kind_leaves(cfg: ModelConfig, kind: str) -> Dict[str, tuple]:
    """The trailing shapes of the cache leaves a layer of ``kind`` carries
    (``"cross"``: a cross layer's rows, beside its attention leaves), in
    the JAX cache's key order."""
    if kind == "cross":
        xd = (cross_len(cfg), cfg.n_kv_heads, cfg.hd)
        return {"xk": xd, "xv": xd}
    if kind == "mamba":
        s = cfg.ssm
        return {"h": (cfg.n_ssm_heads, s.head_dim, s.d_state),
                "conv_x": (s.conv_width - 1, cfg.d_inner),
                "conv_bc": (s.conv_width - 1, 2 * s.n_groups * s.d_state)}
    if cfg.mla is not None:
        return {"ckv": (cfg.mla.kv_lora_rank,), "kpe": (cfg.mla.qk_rope_dim,)}
    return {"k": (cfg.n_kv_heads, cfg.hd), "v": (cfg.n_kv_heads, cfg.hd)}


def _pos_kinds(cfg: ModelConfig, pos: int) -> tuple:
    """The leaf kinds pattern position ``pos`` carries: its mixer's, and
    ``"cross"`` on a cross layer."""
    kind = cfg.layer_kind(pos)
    return (kind, "cross") if cfg.is_cross_layer(pos) else (kind,)


def cache_leaves(cfg: ModelConfig) -> Dict[str, tuple]:
    """Each cache leaf's trailing shape, in the JAX cache's key order
    (position-major, then key): ``k`` / ``v`` [g, hd] or MLA's ``ckv`` [c]
    and ``kpe`` [dr] on attention layers, then on cross layers ``xk`` /
    ``xv`` [F, g, hd], and on Mamba layers the state rows ``h`` [nh, hd,
    ds], ``conv_x`` [K-1, di] and ``conv_bc`` [K-1, 2*g*ds]
    (``STATE_KEYS``, with ``xk`` / ``xv``)."""
    check_supported(cfg)
    out: Dict[str, tuple] = {}
    for pos in range(len(cfg.pattern)):
        for kind in _pos_kinds(cfg, pos):
            for name, dims in _kind_leaves(cfg, kind).items():
                out.setdefault(name, dims)
    return out


def layer_index(cfg: ModelConfig) -> list:
    """Layer ``li``'s (kind, index into its kind's leaves, index into the
    cross rows or None): a leaf holds only the layers that carry it, in
    layer order."""
    seen: Dict[str, int] = {}
    out = []
    for li in range(cfg.n_layers):
        kinds = _pos_kinds(cfg, li % len(cfg.pattern))
        idx = [seen.get(k, 0) for k in kinds]
        for k in kinds:
            seen[k] = seen.get(k, 0) + 1
        out.append((kinds[0], idx[0], idx[1] if len(kinds) > 1 else None))
    return out


def layer_cache(cfg: ModelConfig, cache: Dict, li: int,
                index: Optional[list] = None) -> Dict:
    """Layer ``li``'s dict of views into the cache's leaves."""
    kind, i, xi = (index or layer_index(cfg))[li]
    out = {name: cache[name][i] for name in _kind_leaves(cfg, kind)}
    if xi is not None:
        out.update({name: cache[name][xi]
                    for name in _kind_leaves(cfg, "cross")})
    return out


def _alloc(cfg: ModelConfig, lead: tuple, n_rows: int, device,
           dtype) -> Dict:
    """Block leaves ``[L_kind, *lead, ...]``, state leaves ``[L_kind,
    n_rows, ...]``; ``L_kind`` counts the layers that carry the leaf."""
    count: Dict[str, int] = {}
    for pos in range(len(cfg.pattern)):
        for kind in _pos_kinds(cfg, pos):
            for name in _kind_leaves(cfg, kind):
                count[name] = count.get(name, 0) + cfg.n_periods
    return {name: torch.zeros((count[name],)
                              + ((n_rows,) if name in STATE_KEYS else lead)
                              + dims, device=device, dtype=dtype)
            for name, dims in cache_leaves(cfg).items()}


def init_cache(cfg: ModelConfig, n_rows: int, s_max: int,
               device: torch.device, dtype: torch.dtype) -> Dict:
    """Dense rows: ``{leaf: [L_kind, n_rows, sc, ...]}`` (``k`` / ``v`` or
    MLA's ``ckv`` / ``kpe``) and ``{state leaf: [L_kind, n_rows, ...]}``:
    the JAX layout ``[n_periods, n_rows, ...]`` per pattern position with
    the periods of each kind's positions stacked in layer order."""
    return _alloc(cfg, (n_rows, cache_seq_len(cfg, s_max)), n_rows, device,
                  dtype)


def _dense_write_prompt(rows: torch.Tensor, xh: torch.Tensor,
                        r0: int, s0: int = 0,
                        sc: Optional[int] = None) -> None:
    """In place: prefill rows ``[Bp, Sp, ...]`` land in cache rows
    ``[r0, r0 + Bp)`` at positions ``:Sp``.  A bucket longer than the row
    (``Sp > sc``) takes the rolling write of the JAX model: the last ``sc``
    positions at slots ``p % sc``, so its padding tail overwrites the head
    of the prompt (ROADMAP Queue 3).  ``rows`` may hold only the slots
    ``[s0, s0 + rows.shape[1])`` of rows of ``sc`` slots (MLA's latent
    under a mesh, its sequence cut over "model"): only the positions that
    land there are written."""
    Bp, Sp = xh.shape[:2]
    n = rows.shape[1]
    sc = n if sc is None else sc
    if Sp <= sc:
        lo, hi = min(s0, Sp), min(Sp, s0 + n)
        rows[r0:r0 + Bp, :hi - lo] = xh[:, lo:hi].to(rows.dtype)
    else:
        p = torch.arange(Sp - sc, Sp)
        keep = (p % sc >= s0) & (p % sc < s0 + n)
        p = p[keep].to(xh.device)
        rows[r0:r0 + Bp, p % sc - s0] = xh[:, p].to(rows.dtype)


# ---------------------------------------------------------------------------
# paged KV pool: per layer [n_blocks, block_size, g, hd]; block 0 is the
# reserved null block that absorbs padding writes (masked on read)
# ---------------------------------------------------------------------------

def init_paged_cache(cfg: ModelConfig, n_blocks: int, block_size: int,
                     device: torch.device, dtype: torch.dtype,
                     n_rows: int = 0) -> Dict:
    """The paged pool: ``{leaf: [L_kind, n_blocks, bs, ...]}``, with
    ``n_rows`` dense rows ``[L_kind, n_rows, ...]`` for the state leaves
    (the manager passes ``capacity + pf_capacity``, as the JAX one does);
    ``layer_cache`` gives each layer its views."""
    return _alloc(cfg, (n_blocks, block_size), n_rows, device, dtype)


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


def _paged_view(pool: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """Each row's blocks gathered into one contiguous view ``[B, nbt * bs,
    ...]`` (the JAX model's ``_paged_view``): what MLA attends over."""
    B, nbt = tables.shape
    v = pool[tables.long().clamp(min=0)]
    return v.reshape(B, nbt * pool.shape[1], *pool.shape[2:])


def _paged_chunk_mask(tables: torch.Tensor, block_size: int,
                      pos: torch.Tensor, length: torch.Tensor):
    """``(k_pos, k_valid)`` over the gathered view once a chunk of
    ``length`` tokens was written at ``pos``: positions ``0 .. pos + length
    - 1`` are valid; causality within the chunk comes from the mask's
    position comparison."""
    B, nbt = tables.shape
    j = torch.arange(nbt * block_size, device=tables.device)[None, :]
    k_valid = j < (pos.long() + length.long())[:, None]
    return j.expand(B, nbt * block_size), k_valid


# ---------------------------------------------------------------------------
# attention and FFN sublayers
# ---------------------------------------------------------------------------

def _rope_heads(x: torch.Tensor, pos: torch.Tensor, n: int,
                theta: float) -> torch.Tensor:
    """[B, S, n*hd] -> rope -> [B, S, n, hd]"""
    B, S = x.shape[:2]
    return L.rope(x.reshape(B, S, n, -1), pos, theta)


def _attn_apply(cfg: ModelConfig, p: Dict, lr: Dict, plan: _Plan,
                x: torch.Tensor, cache: Optional[Dict],
                attn_chunk: int = 0, mesh=None) -> torch.Tensor:
    """``cache``: the layer's leaves, ``k``/``v`` of its paged pool
    ``[n_blocks, bs, g, hd]`` or dense rows ``[n_rows, sc, g, hd]``, as the
    buckets' tables say (None for an ft-only batch).  Under a ``mesh``
    (``_sharded_forward``) every rank runs the query and KV heads of its
    ``wq``/``wk``/``wv`` (column-parallel where the head count divides the
    model axis, else whole: ``_Heads``) over its cache shard, in the layout
    ``plan.kv_layout`` names: the KV heads (each rank's query heads read
    its own), the head dim (``_hd_decode``) or the slots
    (``_seq_decode``); ``wo`` row-parallel with its all-reduce, or whole
    where ``wq`` is."""
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    xn = L.rms_norm(x, p["ln1"], cfg.rms_eps)
    if cfg.mla is not None:
        out = _mla_apply(cfg, p, lr, plan, xn, cache, attn_chunk, mesh)
        if mesh is not None:
            return x + dense_row(out, p["wo"], lr.get("wo"), plan.route,
                                 mesh)
        return x + dense(out, p["wo"], None, lr.get("wo"), plan.route)
    k_pool, v_pool = (cache["k"], cache["v"]) if cache else (None, None)

    def dn(name, bias=None):
        return dense(xn, p[name], p.get(bias) if bias else None,
                     lr.get(name), plan.route)

    heads, fit = None, (lambda t: t)
    if mesh is None:
        q, k, v = dn("wq", "bq"), dn("wk", "bk"), dn("wv", "bv")
    else:
        q_cut = p["wq"].shape[1] < h * hd
        kv_cut = p["wk"].shape[1] < kv * hd
        q, k, v = dense_col(xn, [
            (p[w], p.get(b), lr.get(w), _read(cut, q_cut))
            for w, b, cut in (("wq", "bq", q_cut), ("wk", "bk", kv_cut),
                              ("wv", "bv", kv_cut))], plan.route, mesh)
        heads = plan.heads(cfg, mesh, q.shape[1] // hd, k.shape[1] // hd)
        h, kv, fit = heads.h, heads.kv, heads.fit
    qf, qp, qd = plan.split(q)
    kf, kp, kd = plan.split(k)
    vf, vp, vd = plan.split(v)
    # serving rows carry no gradient (the kernels have no backward, and the
    # cache writes must stay out of the graph)
    qp, kp, vp, qd, kd, vd = (t if t is None else t.detach()
                              for t in (qp, kp, vp, qd, kd, vd))
    outs = [None, None, None]
    if qf is not None:           # fine-tune / eval: differentiable causal
        qh = _rope_heads(qf, plan.ft_pos, h, cfg.rope_theta)
        kh = _rope_heads(kf, plan.ft_pos, kv, cfg.rope_theta)
        vh = vf.reshape(plan.Bf, plan.Sf, kv, hd)
        outs[0] = L.attention(qh, fit(kh), fit(vh), q_pos=plan.ft_pos,
                              k_pos=plan.ft_pos, k_valid=plan.ft_valid,
                              causal=True, window=cfg.sliding_window,
                              chunk=attn_chunk)
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
            outs[1] = paged_prefill_attention(
                qh, k_pool, v_pool, pf.block_tables, plan.pf_cached,
                pf.length)
        else:
            # cold prefill: prompt-local causal attention over the bucket's
            # own K/V (flash attention), then into the blocks or the rows
            outs[1] = ops.flash_attention(qh, fit(kh), fit(vh), pf.length,
                                          causal=True,
                                          window=cfg.sliding_window)
            if pf.block_tables is not None:
                _paged_write_prompt(k_pool, kh, pf.block_tables)
                _paged_write_prompt(v_pool, vh, pf.block_tables)
            elif mesh is None:
                _dense_write_prompt(k_pool, kh, plan.Bd)
                _dense_write_prompt(v_pool, vh, plan.Bd)
            else:
                _write_rows_sharded(plan.kv_layout, (k_pool, v_pool),
                                    (kh, vh), plan.Bd, mesh)
    if qd is not None and plan.dec.block_tables is None:   # dense decode
        qh = _rope_heads(qd, plan.dec_qpos, h, cfg.rope_theta)
        kh = _rope_heads(kd, plan.dec_qpos, kv, cfg.rope_theta)
        vh = vd.reshape(plan.Bd, 1, kv, hd)
        if mesh is not None and plan.kv_layout != "heads":
            valid = _write_slot_sharded(plan.kv_layout, kh[:, 0], vh[:, 0],
                                        k_pool, v_pool, plan.dec_pos, mesh)
            outs[2] = _attend_sharded(
                cfg, plan.kv_layout, heads, qh[:, 0], k_pool[:plan.Bd],
                v_pool[:plan.Bd], valid, mesh)[:, None]
        else:
            rows = torch.arange(plan.Bd, device=x.device)
            slot = plan.dec_pos.long() % k_pool.shape[1]
            k_pool[rows, slot] = kh[:, 0].to(k_pool.dtype)
            v_pool[rows, slot] = vh[:, 0].to(v_pool.dtype)
            outs[2] = ops.decode_attention(qh[:, 0].contiguous(),
                                           k_pool[:plan.Bd],
                                           v_pool[:plan.Bd],
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
        outs[2] = o
    out = _merge_flat(plan, *outs)
    if mesh is not None:
        return x + dense_row(out, p["wo"], lr.get("wo"), plan.route, mesh,
                             whole=heads.q_whole)
    return x + dense(out, p["wo"], None, lr.get("wo"), plan.route)


# ---------------------------------------------------------------------------
# GQA under a mesh: a rank's heads, and the head-dim and sequence layouts of
# its KV rows (``distributed.sharding.kv_layout``)
# ---------------------------------------------------------------------------

def _read(cut: bool, others_cut: bool) -> str:
    """How the ranks read a column-parallel projection's output
    (``core.lora.dense_col``'s ``read``): ``"cut"`` where its columns are
    cut; where it is whole, ``"differ"`` if each rank's heads read part of
    it (whole ``wk`` / ``wv`` beside cut query heads), else ``"alike"``
    (the sublayer runs whole on every rank)."""
    return "cut" if cut else "differ" if others_cut else "alike"


class _Heads:
    """A rank's query and KV heads under a mesh: ``h`` query heads from
    ``q0`` and ``kv`` KV heads from ``k0`` (every head, from 0, where the
    projection is whole: its head count does not divide the model axis).
    ``fit`` gives each local query head the local KV head it reads: the
    rank's KV heads as they are when its query heads are whole groups of
    them, else one KV head per query head (MHA form, h/g = 1: a rank's
    query heads straddle KV groups, as phi3's 10 a rank over groups of
    4)."""

    def __init__(self, cfg: ModelConfig, mesh, h: int, kv: int, device):
        c, m = mesh.coords["model"], mesh.shape["model"]
        self.h, self.kv = h, kv
        self.q0 = c * h if h < cfg.n_heads else 0
        self.k0 = c * kv if kv < cfg.n_kv_heads else 0
        self.q_whole = h == cfg.n_heads and m > 1
        grp = cfg.n_heads // cfg.n_kv_heads
        need = [(self.q0 + j) // grp - self.k0 for j in range(h)]
        if self.q0 % grp == 0 and h % grp == 0:
            self.sel = None if (need[0], h // grp) == (0, kv) else \
                slice(need[0], need[0] + h // grp)
        else:
            self.sel = torch.tensor(need, device=device)

    def fit(self, t: torch.Tensor) -> torch.Tensor:
        """[..., kv, hd] -> [..., n, hd], n dividing the rank's h."""
        if self.sel is None:
            return t
        if isinstance(self.sel, slice):
            return t[..., self.sel, :].contiguous()
        return t.index_select(t.ndim - 2, self.sel)


def _write_rows_sharded(layout: str, rows: tuple, xs: tuple, r0: int,
                        mesh) -> None:
    """In place: prefill K/V ``xs`` [Bp, Sp, kv, hd] (this rank's KV heads,
    or all of them where ``wk`` is whole) into this rank's shards ``rows``
    [n_rows, S', g', hd'] at rows ``[r0, r0 + Bp)``, as
    ``_dense_write_prompt`` writes a whole row: ``"heads"`` the rank's own
    heads; ``"head_dim"`` its slice of the head dim of every head; ``"seq"``
    its slots ``[s0, s0 + S')`` of every head, the rolling write of a
    bucket longer than the row included.  Under ``"seq"`` with the KV heads
    cut, each rank sends every other rank the prompt's K/V at the slots
    that rank owns, in one all-to-all over "model" (``B * S * kv * hd``
    elements a rank, K and V together)."""
    c, m = mesh.coords["model"], mesh.shape["model"]
    if layout == "heads":
        for r, x in zip(rows, xs):
            _dense_write_prompt(r, x, r0)
        return
    if layout == "head_dim":
        hl = rows[0].shape[-1]
        for r, x in zip(rows, xs):
            _dense_write_prompt(r, x[..., c * hl:(c + 1) * hl], r0)
        return
    sl = rows[0].shape[1]
    sc = sl * m
    if xs[0].shape[2] == rows[0].shape[2]:     # every KV head on every rank
        for r, x in zip(rows, xs):
            _dense_write_prompt(r, x, r0, c * sl, sc)
        return
    kv = torch.stack(xs)                       # [2, B, Sp, kv, hd]
    _, B, Sp, kvl, hd = kv.shape
    if Sp <= sc:                               # the row's image: slot = pos
        img = F.pad(kv, (0, 0, 0, 0, 0, sc - Sp))
    else:                                      # the last sc positions, rolled
        img = torch.roll(kv[:, :, Sp - sc:], (Sp - sc) % sc, dims=2)
    img = img.reshape(2, B, m, sl, kvl, hd).permute(2, 0, 1, 3, 4, 5)
    got = SH.all_to_all(img, "model", mesh)    # [m: the sender's heads, ...]
    got = got.permute(1, 2, 3, 0, 4, 5).reshape(2, B, sl, m * kvl, hd)
    n = min(Sp, sc) - c * sl                   # slots of this rank written
    if n > 0:
        for r, x in zip(rows, got):
            r[r0:r0 + B, :min(n, sl)] = x[:, :min(n, sl)].to(r.dtype)


def _write_slot_sharded(layout: str, k: torch.Tensor, v: torch.Tensor,
                        k_rows: torch.Tensor, v_rows: torch.Tensor,
                        pos: torch.Tensor, mesh) -> torch.Tensor:
    """In place: a decode's fresh ``k`` / ``v`` [B, kv', hd] at ``pos`` [B]
    into this rank's rows ``k_rows`` / ``v_rows`` [n_rows, S', g', hd'] cut
    by the head dim (the rank's slice of every head) or by the slots (the
    slot's owner writes every head, gathered over "model" where ``wk`` is
    cut).  Returns the validity [B, S'] of the rank's slots."""
    c, m = mesh.coords["model"], mesh.shape["model"]
    B = k.shape[0]
    rows = torch.arange(B, device=k.device)
    sl = k_rows.shape[1]
    if layout == "head_dim":
        hl = k_rows.shape[-1]
        slot = pos.long() % sl
        k_rows[rows, slot] = k[..., c * hl:(c + 1) * hl].to(k_rows.dtype)
        v_rows[rows, slot] = v[..., c * hl:(c + 1) * hl].to(v_rows.dtype)
        return L.dec_cache_pos(pos, sl)[1]
    kv = torch.stack([k, v])                            # [2, B, kv', hd]
    if kv.shape[2] < k_rows.shape[2]:
        kv = SH.all_gather(kv, "model", mesh, dim=2)
    slot = pos.long() % (sl * m)
    # the rank that holds the slot writes it; the others write their own
    # slot's value back (no host sync)
    own = ((slot >= c * sl) & (slot < (c + 1) * sl))[:, None, None]
    ls = (slot - c * sl).clamp(0, sl - 1)
    for r, t in zip((k_rows, v_rows), kv):
        r[rows, ls] = torch.where(own, t.to(r.dtype), r[rows, ls])
    return L.dec_cache_pos(pos, sl * m)[1][:, c * sl:(c + 1) * sl]


def _attend_sharded(cfg: ModelConfig, layout: str, heads: _Heads,
                    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    k_valid: torch.Tensor, mesh) -> torch.Tensor:
    """Decode attention of this rank's query heads ``q`` [B, h', hd] over
    its rows ``k`` / ``v`` [B, S', g', hd'] cut by the head dim
    (``_hd_decode``) or by the slots (``_seq_decode``; ``k_valid`` [B, S']
    is then a prefix of the rank's slots), every head's query gathered over
    "model" where ``wq`` is cut.  Returns [B, h', hd]."""
    if heads.h < cfg.n_heads:
        q = SH.all_gather(q.contiguous(), "model", mesh, dim=1)
    if layout == "head_dim":
        o = _hd_decode(q, k, v, k_valid, cfg.hd ** -0.5, mesh)
        return o[:, heads.q0:heads.q0 + heads.h]
    return _seq_decode(q, k, v, k_valid.sum(-1), heads, mesh)[:, 0]


def hd_partial_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """This rank's share of every head's decode scores over rows cut by the
    head dim: q [B, h, hd'] (every head, the rank's slice of the head dim),
    k [B, S, g, hd'] -> fp32 [B, g, h/g, S], the dot products over the
    slice (summed over "model" by ``_hd_decode``)."""
    B, h, hl = q.shape
    g = k.shape[2]
    return torch.einsum("bgrd,bsgd->bgrs", q.float().reshape(B, g, h // g, hl),
                        k.float())


def _hd_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               k_valid: torch.Tensor, scale: float, mesh) -> torch.Tensor:
    """Decode attention over KV rows cut by the head dim (plain PyTorch: a
    score is a sum over the cut axis, so no single-rank kernel computes
    it).  q [B, h, hd] every head whole; k / v [B, S, g, hd/m] this rank's
    slice; k_valid [B, S].  The partial scores (``hd_partial_scores``) go
    in one all-reduce over "model" (fp32 [B, h, S]); every rank takes the
    softmax, weighs its slice of V, and the [B, h, hd/m] outputs are
    all-gathered over the head dim.  Returns [B, h, hd]."""
    c = mesh.coords["model"]
    B, h, hd = q.shape
    hl = k.shape[-1]
    s = SH.all_reduce(hd_partial_scores(q[..., c * hl:(c + 1) * hl], k),
                      "model", mesh) * scale
    s = s.masked_fill(~k_valid[:, None, None, :], L.NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrs,bsgd->bgrd", p, v.float()).reshape(B, h, hl)
    return SH.all_gather(o.to(q.dtype), "model", mesh, dim=2)


def _rows_block(n: int) -> int:
    """The block size at which a rank's ``n`` slots are read as a paged pool
    (``seq_partials``): the largest power of two <= 64 dividing ``n``."""
    return min(n & -n, 64)


def seq_partials(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 n_valid: torch.Tensor):
    """One rank's flash-decoding partials over the slots it holds, for every
    head: q [B, h, hd], k / v [B, t, g, hd] (a contiguous prefix of a cache
    leaf's rows), ``n_valid`` [B] the number of valid slots, which on a
    dense row are always a prefix of the rank's slots (``L.dec_cache_pos``:
    slot j is valid iff j <= pos, rolling or not; cross rows: all).  Split-K's
    partial kernel (``kernels.splitk.splitk_partials``) reads the rows as a
    pool of ``t / bs`` blocks a row, the query at local position ``n_valid
    - 1``; a row with no valid slot gives ``(o, m, l) = (0, NEG_INF, 0)``.
    Returns fp32 (o [B, ns, 1, h, hd], m [B, ns, 1, h], l [B, ns, 1,
    h])."""
    B, t, g, hd = k.shape
    bs = _rows_block(t)
    nb = t // bs
    tbl = torch.arange(B * nb, dtype=torch.int32,
                       device=q.device).reshape(B, nb)
    ns = autotune.choose(hd, bs, nb, B * g, lanes=autotune.effective_lanes(
        q.device)).num_splits
    o, mx, l = splitk_partials(
        q[:, None].contiguous(), k.reshape(B * nb, bs, g, hd),
        v.reshape(B * nb, bs, g, hd), tbl,
        (n_valid - 1).clamp(min=0).to(torch.int32),
        torch.ones((B,), dtype=torch.int32, device=q.device), ns)
    none = (n_valid == 0)[:, None, None, None]
    return (o.masked_fill(none[..., None], 0.0),
            mx.masked_fill(none, L.NEG_INF), l.masked_fill(none, 0.0))


def _seq_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                n_valid: torch.Tensor, heads: _Heads, mesh) -> torch.Tensor:
    """Decode over KV rows cut by the slots (flash decoding over the ranks,
    the GQA twin of ``_mla_decode_sharded``): q [B, h, hd] every head; k /
    v [B, t, g, hd] this rank's slots of every KV head.  Each rank computes
    every head's partials over its slots (``seq_partials``); one all-to-all
    over "model" brings each head's partials to the rank that holds the
    head (an all-gather where ``wq`` is whole and every rank holds every
    head), which merges them with split-K's merge kernel (``_lse_merge``).
    Returns [B, 1, h', hd]."""
    m = mesh.shape["model"]
    B, h, hd = q.shape
    o, mx, l = seq_partials(q, k, v, n_valid)
    ns = o.shape[1]
    pack = torch.cat([o, mx[..., None], l[..., None]], -1)  # [B,ns,1,h,hd+2]
    if heads.h == h:
        got = SH.all_gather(pack, "model", mesh, dim=1)
    else:
        pack = pack.reshape(B, ns, 1, m, heads.h, hd + 2)
        got = SH.all_to_all(pack.permute(3, 0, 1, 2, 4, 5), "model", mesh)
        got = got.permute(1, 0, 2, 3, 4, 5).reshape(B, m * ns, 1, heads.h,
                                                    hd + 2)
    return _lse_merge(got[..., :hd], got[..., hd], got[..., hd + 1], q.dtype)


def _mla_apply(cfg: ModelConfig, p: Dict, lr: Dict, plan: _Plan,
               xn: torch.Tensor, cache: Optional[Dict],
               attn_chunk: int = 0, mesh=None) -> torch.Tensor:
    """Absorbed-form MLA over every bucket (``_mla_apply`` of the JAX model);
    ``cache``: the layer's ``ckv`` [.., c] and ``kpe`` [.., dr] leaves, a
    paged pool or dense rows.  Returns the attention output ``[T, h*dv]``,
    before ``wo``.  Under a ``mesh`` (dense rows) a rank runs its h/m heads
    (``wq``, ``wuk``, ``wuv`` cut by heads) over the whole latent of its
    rows (``wdkv`` whole on every model rank) and holds the slots ``[s0,
    s0 + sc/m)`` of every latent row (``cache_shardings``: the sequence
    over "model"): ft and cold prefill attend over the bucket's fresh
    latent (with ``window=W`` under a sliding window), each rank writing
    its own slots (of a rolling row of W slots under a window: the
    positions whose slot ``pos % W`` it holds, ``_dense_write_prompt``);
    decode is flash decoding over the ranks (``_mla_decode_sharded``, the
    slots' positions from ``L.dec_cache_pos``).  Returns this rank's heads'
    ``[T, h/m*dv]``."""
    m, h = cfg.mla, cfg.n_heads
    dnp, dr, c_rank = m.qk_nope_dim, m.qk_rope_dim, m.kv_lora_rank
    if mesh is None:
        q = dense(xn, p["wq"], None, lr.get("wq"), plan.route)
        lat = dense(xn, p["wdkv"], None, lr.get("wdkv"), plan.route)
        n_model = 1
    else:
        n_model = mesh.shape["model"]
        h //= n_model
        # wdkv is whole: every rank's heads read its latent in part
        q, lat = dense_col(xn, [(p["wq"], None, lr.get("wq"), "cut"),
                                (p["wdkv"], None, lr.get("wdkv"), "differ")],
                           plan.route, mesh)
    # q [T, h*(dn+dr)], lat [T, c+dr]
    qf, qp, qd = plan.split(q)
    cf, cp, cd = plan.split(lat)
    # serving rows carry no gradient, and the cache writes stay out of the
    # graph
    qp, cp, qd, cd = (t if t is None else t.detach()
                      for t in (qp, cp, qd, cd))
    wuk, wuv = p["wuk"], p["wuv"]
    theta = cfg.rope_theta

    def heads(qb, pos):
        """[B, S, h*(dn+dr)] -> (q_nope, roped q_pe)"""
        qb = qb.reshape(*qb.shape[:2], h, dnp + dr)
        return qb[..., :dnp], L.rope(qb[..., dnp:], pos, theta)

    def latent(cb, pos):
        """[B, S, c+dr] -> (ckv, kpe roped as one shared head)"""
        return cb[..., :c_rank], L.rope(cb[..., None, c_rank:], pos,
                                        theta)[..., 0, :]

    outs = [None, None, None]
    if qf is not None:           # fine-tune / eval: differentiable causal
        qn, qr = heads(qf, plan.ft_pos)
        ckv, kpe = latent(cf, plan.ft_pos)
        outs[0] = L.mla_attention(qn, qr, ckv, kpe, wuk, wuv,
                                  q_pos=plan.ft_pos, k_pos=plan.ft_pos,
                                  k_valid=plan.ft_valid, causal=True,
                                  window=cfg.sliding_window,
                                  chunk=attn_chunk)
    if qp is not None:           # prefill: causal + cache write
        pf = plan.pf
        qn, qr = heads(qp, plan.pf_pos)
        ckv, kpe = latent(cp, plan.pf_pos)
        tbl = pf.block_tables
        if tbl is not None and plan.pf_cached is not None:
            # suffix-only prefill: write the suffix latent at its offset,
            # then attend over the gathered view, so the cached prefix
            # latent is read, not recomputed
            _paged_write_chunk(cache["ckv"], ckv, tbl, plan.pf_cached,
                               pf.length)
            _paged_write_chunk(cache["kpe"], kpe, tbl, plan.pf_cached,
                               pf.length)
            k_pos, k_valid = _paged_chunk_mask(
                tbl, cache["ckv"].shape[1], plan.pf_cached, pf.length)
            outs[1] = L.mla_attention(
                qn, qr, _paged_view(cache["ckv"], tbl),
                _paged_view(cache["kpe"], tbl), wuk, wuv, q_pos=plan.pf_pos,
                k_pos=k_pos, k_valid=k_valid, causal=True, chunk=attn_chunk)
        else:
            # cold prefill: over the bucket's own latent, then into the
            # blocks or the rows
            outs[1] = L.mla_attention(qn, qr, ckv, kpe, wuk, wuv,
                                      q_pos=plan.pf_pos, k_pos=plan.pf_pos,
                                      k_valid=plan.pf_valid, causal=True,
                                      window=cfg.sliding_window,
                                      chunk=attn_chunk)
            for name, xh in (("ckv", ckv), ("kpe", kpe)):
                if tbl is not None:
                    _paged_write_prompt(cache[name], xh, tbl)
                else:
                    sl = cache[name].shape[1]
                    s0 = mesh.coords["model"] * sl if mesh else 0
                    _dense_write_prompt(cache[name], xh, plan.Bd, s0,
                                        sl * n_model)
    if qd is not None:           # decode / verify: (1 + k)-token chunk
        dec, dpos = plan.dec, plan.dec_qpos
        qn, qr = heads(qd, dpos)
        ckv, kpe = latent(cd, dpos)
        tbl = dec.block_tables
        if tbl is not None:      # paged: chunk write, gathered view
            _paged_write_chunk(cache["ckv"], ckv, tbl, plan.dec_pos,
                               plan.dec_len)
            _paged_write_chunk(cache["kpe"], kpe, tbl, plan.dec_pos,
                               plan.dec_len)
            k_pos, k_valid = _paged_chunk_mask(
                tbl, cache["ckv"].shape[1], plan.dec_pos, plan.dec_len)
            cc = _paged_view(cache["ckv"], tbl)
            ce = _paged_view(cache["kpe"], tbl)
        else:                    # dense rows: one token into its slot
            rows = torch.arange(plan.Bd, device=xn.device)
            sl = cache["ckv"].shape[1]
            sc = sl * n_model
            slot = plan.dec_pos.long() % sc
            if mesh is None:
                cache["ckv"][rows, slot] = ckv[:, 0].to(cache["ckv"].dtype)
                cache["kpe"][rows, slot] = kpe[:, 0].to(cache["kpe"].dtype)
            else:
                # the rank that holds the slot writes it; the others write
                # their own slot's value back (no host sync)
                s0 = mesh.coords["model"] * sl
                own = ((slot >= s0) & (slot < s0 + sl))[:, None]
                ls = (slot - s0).clamp(0, sl - 1)
                for name, t in (("ckv", ckv), ("kpe", kpe)):
                    c = cache[name]
                    c[rows, ls] = torch.where(own, t[:, 0].to(c.dtype),
                                              c[rows, ls])
            k_pos, k_valid = L.dec_cache_pos(
                plan.dec_pos + plan.dec_len - 1, sc)
            cc, ce = cache["ckv"][:plan.Bd], cache["kpe"][:plan.Bd]
            if mesh is not None:
                s0 = mesh.coords["model"] * sl
                outs[2] = _mla_decode_sharded(
                    qn, qr, cc, ce, wuk, wuv, dpos, k_pos[:, s0:s0 + sl],
                    k_valid[:, s0:s0 + sl], mesh)
                return _merge_flat(plan, *outs)
        outs[2] = L.mla_attention(qn, qr, cc, ce, wuk, wuv, q_pos=dpos,
                                  k_pos=k_pos, k_valid=k_valid, causal=True)
    return _merge_flat(plan, *outs)


def mla_partials(q_lat: torch.Tensor, q_pe: torch.Tensor, ckv: torch.Tensor,
                 kpe: torch.Tensor, q_pos: torch.Tensor, k_pos: torch.Tensor,
                 k_valid: torch.Tensor, scale: float):
    """One rank's flash-decoding partials of absorbed MLA over the latent
    slots it holds, for every head: q_lat [B, S, h, c], q_pe [B, S, h, dr],
    ckv [B, t, c], kpe [B, t, dr] -> (o [B, S, h, c], m, l [B, S, h]), all
    fp32: ``m`` the max score over the valid keys, ``l`` the sum of
    ``exp(score - m)`` and ``o`` that weighted sum of ``ckv``, unnormalized
    (``kernels.splitk.lse_merge``'s partials).  A rank with no valid key
    gives ``o = l = 0``, so its merge weight is 0."""
    s = torch.einsum("bshc,btc->bhst", q_lat, ckv).float()
    s = (s + torch.einsum("bshd,btd->bhst", q_pe, kpe).float()) * scale
    mask = L._build_mask(q_pos, k_pos, k_valid, True, 0)[:, None]
    s = s.masked_fill(~mask, L.NEG_INF)
    mx = s.amax(-1)                                              # [B, h, S]
    e = torch.exp(s - mx[..., None]) * mask
    o = torch.einsum("bhst,btc->bshc", e, ckv.float())
    return o, mx.transpose(1, 2), e.sum(-1).transpose(1, 2)


def _lse_merge(o: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """``kernels.splitk.lse_merge`` (split-K's merge kernel on the card)
    over partials [B, ns, S, h, c]: a latent wider than the kernel's 256
    columns is merged as ``c / 256`` heads of 256 columns each (the merge
    is per column, its weights per head)."""
    B, ns, S, h, c = o.shape
    f = c // 256 if c > 256 and c % 256 == 0 else 1
    if f > 1:
        o = o.reshape(B, ns, S, h * f, c // f)
        m, l = m.repeat_interleave(f, -1), l.repeat_interleave(f, -1)
    return lse_merge(o.contiguous(), m.contiguous(), l.contiguous(),
                     dtype).reshape(B, S, h, c)


def _mla_decode_sharded(qn: torch.Tensor, qr: torch.Tensor,
                        ckv: torch.Tensor, kpe: torch.Tensor,
                        wuk: torch.Tensor, wuv: torch.Tensor,
                        q_pos: torch.Tensor, k_pos: torch.Tensor,
                        k_valid: torch.Tensor, mesh) -> torch.Tensor:
    """MLA decode over a latent whose slots are cut over "model": this
    rank's heads' queries qn [B, S, h/m, dn] / qr [B, S, h/m, dr], its
    slots ckv [B, t, c] / kpe [B, t, dr] and their positions.  The absorbed
    query of every head is all-gathered over "model"; each rank computes
    every head's partials over its own slots (``mla_partials``); one
    all-to-all brings each head's partials to the rank that holds the
    head, which merges them (``_lse_merge``) and applies ``wuv``.  Returns
    [B, S, h/m, dv]."""
    n = mesh.shape["model"]
    B, S, hl, dn = qn.shape
    c = ckv.shape[-1]
    q_lat = torch.einsum("bshd,chd->bshc", qn, wuk.to(qn.dtype))
    qa = SH.all_gather(torch.cat([q_lat, qr], -1), "model", mesh, dim=2)
    o, mx, l = mla_partials(qa[..., :c], qa[..., c:], ckv, kpe, q_pos,
                            k_pos, k_valid, (dn + qr.shape[-1]) ** -0.5)
    pack = torch.cat([o, mx[..., None], l[..., None]], -1)   # [B, S, h, c+2]
    pack = pack.reshape(B, S, n, hl, c + 2).permute(2, 0, 1, 3, 4)
    got = SH.all_to_all(pack, "model", mesh).permute(1, 0, 2, 3, 4)
    o_lat = _lse_merge(got[..., :c], got[..., c], got[..., c + 1], qn.dtype)
    return torch.einsum("bshc,chd->bshd", o_lat, wuv.to(qn.dtype))


def _cross_apply(cfg: ModelConfig, p: Dict, lr: Dict, plan: _Plan,
                 x: torch.Tensor, cache: Optional[Dict],
                 attn_chunk: int = 0, mesh=None) -> torch.Tensor:
    """The cross-attention sublayer (``_cross_apply`` of the JAX model): a
    query ``xwq`` through ``dense`` (LoRA when targeted), non-causal
    attention over the cross source's keys, ``xwo`` through ``dense``, the
    output gated by ``tanh(xgate)`` and added to the residual.  The ft and
    prefill buckets project their ``aux_embed`` [B, F, d] through ``xwk`` /
    ``xwv`` (plain products); prefill writes the projections into the
    layer's ``xk`` / ``xv`` rows ``[Bd, Bd + Bp)`` and decode (plain or
    verify chunks) reads rows ``[0, Bd)``.  ``cache``: the layer's views
    (None for an ft-only batch).  Under a ``mesh`` a rank runs the heads of
    its ``xwq`` / ``xwk`` / ``xwv`` (column-parallel where the head count
    divides the model axis, else whole: ``_Heads``), ``xwo`` row-parallel
    with its all-reduce or whole where ``xwq`` is; its ``xk`` / ``xv`` rows
    are cut as ``plan.x_layout`` says (the KV heads, the head dim or the
    source positions, as ``_attn_apply``'s rows; decode without a mask);
    ``xgate`` is whole on every rank.  Under a gradient only the ft rows'
    query carries one: ``xwq`` enters through ``dense_col`` (its input's
    gradient summed over "model" where the heads are cut, read alike where
    they are whole), ``xwo`` through ``dense_row``, and K/V, made from
    sources that are not trained, carry none."""
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    xn = L.rms_norm(x, p["xln"], cfg.rms_eps)
    heads = None
    if mesh is None:
        q = dense(xn, p["xwq"], None, lr.get("xwq"), plan.route)
    else:
        q, = dense_col(xn, [(p["xwq"], None, lr.get("xwq"), _read(
            p["xwq"].shape[1] < h * hd, False))], plan.route, mesh)
        heads = plan.heads(cfg, mesh, q.shape[1] // hd,
                           p["xwk"].shape[1] // hd)
        h, kv = heads.h, heads.kv
    qf, qp, qd = plan.split(q)
    # serving rows carry no gradient, and the row writes stay out of the
    # graph
    qp, qd = (t if t is None else t.detach() for t in (qp, qd))

    def kv_from(src):            # [B, F, d] -> K, V [B, F, g, hd]
        # the sources carry no gradient: an FSDPWeight is gathered whole
        B, F = src.shape[:2]
        flat = src.reshape(B * F, -1)
        w = lambda n: p[n] if isinstance(p[n], SH.FSDPWeight) \
            else p[n].to(src.dtype)
        return (SH.matmul(flat, w("xwk")).reshape(B, F, kv, hd),
                SH.matmul(flat, w("xwv")).reshape(B, F, kv, hd))

    def xattn(qb, kx, vx, qpos):
        B, S = qb.shape[:2]
        F = kx.shape[1]
        if heads is not None:
            kx, vx = heads.fit(kx), heads.fit(vx)
        kpos = torch.zeros((B, F), dtype=torch.int32, device=kx.device)
        valid = torch.ones((B, F), dtype=torch.bool, device=kx.device)
        return L.attention(qb.reshape(B, S, h, hd), kx, vx, q_pos=qpos,
                           k_pos=kpos, k_valid=valid, causal=False,
                           chunk=attn_chunk)

    outs = [None, None, None]
    if qf is not None:           # fine-tune / eval: under autograd
        kx, vx = kv_from(plan.ft.aux_embed.to(x.dtype))
        outs[0] = xattn(qf, kx, vx, plan.ft_pos)
    if qp is not None:           # prefill: rows [Bd, Bd + Bp)
        kx, vx = kv_from(plan.pf.aux_embed.to(x.dtype))
        outs[1] = xattn(qp, kx, vx, plan.pf_pos)
        if mesh is None:
            rows = slice(plan.Bd, plan.Bd + plan.Bp)
            cache["xk"][rows] = kx.to(cache["xk"].dtype)
            cache["xv"][rows] = vx.to(cache["xv"].dtype)
        else:
            _write_rows_sharded(plan.x_layout, (cache["xk"], cache["xv"]),
                                (kx, vx), plan.Bd, mesh)
    if qd is not None:           # decode / verify: rows [0, Bd)
        xk, xv = cache["xk"][:plan.Bd], cache["xv"][:plan.Bd]
        if mesh is None or plan.x_layout == "heads":
            outs[2] = xattn(qd, xk, xv, plan.dec_qpos)
        else:                    # every source position valid
            outs[2] = _attend_sharded(
                cfg, plan.x_layout, heads, qd.reshape(plan.Bd, h, hd), xk,
                xv, torch.ones(xk.shape[:2], dtype=torch.bool,
                               device=xk.device), mesh)[:, None]
    o = _merge_flat(plan, *outs)
    if mesh is None:
        o = dense(o, p["xwo"], None, lr.get("xwo"), plan.route)
    else:
        o = dense_row(o, p["xwo"], lr.get("xwo"), plan.route, mesh,
                      whole=heads.q_whole)
    return x + torch.tanh(p["xgate"]).to(o.dtype) * o


def encoder_forward(cfg: ModelConfig, enc: Dict, frames: torch.Tensor,
                    mesh=None, prep=None) -> torch.Tensor:
    """The Whisper encoder (``encoder_forward`` of the JAX model) over
    ``frames`` [B, F, d]: per layer rms_norm, plain q/k/v/o products,
    bidirectional attention and a SwiGLU, no LoRA; then the final norm.
    Under a ``mesh`` the leaves are this rank's shards, ``prep(i, layer)``
    making layer ``i``'s ready (whole over "data", dequantized): ``wq`` /
    ``wk`` / ``wv`` / ``wg`` / ``wu`` column-parallel, ``wo`` / ``wd``
    row-parallel, one all-reduce over "model" a sublayer; a leaf whose
    heads (or FFN width) do not divide the axis is whole (``_Heads``), and
    a whole ``wo`` / ``wd`` needs no all-reduce."""
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    B, F, d = frames.shape
    kpos = torch.zeros((B, F), dtype=torch.int32, device=frames.device)
    valid = torch.ones((B, F), dtype=torch.bool, device=frames.device)
    d_ff = encoder_shapes(cfg)["wd"].shape[0]

    def reduce(y, whole):
        return y if mesh is None or whole else SH.all_reduce(y, "model",
                                                             mesh)
    x = frames
    for i, p in enumerate(enc["layers"]):
        p = p if prep is None else prep(i, p)
        fit = lambda t: t
        if mesh is not None:
            heads = _Heads(cfg, mesh, p["wq"].shape[1] // hd,
                           p["wk"].shape[1] // hd, frames.device)
            h, kv, fit = heads.h, heads.kv, heads.fit
        flat = L.rms_norm(x, p["ln1"], cfg.rms_eps).reshape(B * F, d)
        q = (flat @ p["wq"].to(x.dtype)).reshape(B, F, h, hd)
        k = (flat @ p["wk"].to(x.dtype)).reshape(B, F, kv, hd)
        v = (flat @ p["wv"].to(x.dtype)).reshape(B, F, kv, hd)
        o = L.attention(q, fit(k), fit(v), q_pos=kpos, k_pos=kpos,
                        k_valid=valid, causal=False)
        x = x + reduce(o.reshape(B * F, h * hd) @ p["wo"].to(x.dtype),
                       h == cfg.n_heads).reshape(B, F, d)
        xn = L.rms_norm(x, p["ln2"], cfg.rms_eps).reshape(B * F, d)
        x = x + reduce(L.swiglu(xn, p["wg"], p["wu"], p["wd"]),
                       p["wd"].shape[0] == d_ff).reshape(B, F, d)
    return L.rms_norm(x, enc["final_norm"], cfg.rms_eps)


def _cross_sources(cfg: ModelConfig, params: Dict, plan: _Plan,
                   dtype: torch.dtype, mesh=None, prep=None) -> None:
    """A cross model's ft and prefill buckets must carry ``aux_embed``;
    with an encoder it is replaced by the encoder's output, as in the JAX
    model (no graph: neither the encoder nor the sources are trained).
    ``mesh`` / ``prep``: ``encoder_forward``'s, under a mesh."""
    for name in ("ft", "pf"):
        b = getattr(plan, name)
        if b is None:
            continue
        if b.aux_embed is None:
            raise ValueError(
                f"{cfg.name} has cross-attention layers: its {name} bucket "
                "needs aux_embed, the [B, F, d] cross source embeddings")
        if cfg.encoder is not None:
            enc = encoder_forward(cfg, params["encoder"],
                                  b.aux_embed.to(dtype), mesh, prep)
            setattr(plan, name, b._replace(aux_embed=enc))


def _expand_bc(cfg: ModelConfig, y_bc: torch.Tensor, lead: tuple,
               h0: int, nh: int):
    """[.., 2*g*ds] -> (B, C) [.., nh, ds] for the ``nh`` SSM heads from
    head ``h0``: each head takes its group's B / C, the group of global
    head ``j`` being ``j // (n_ssm_heads / g)`` (``mamba.expand_groups``
    over every head)."""
    s = cfg.ssm
    gds = s.n_groups * s.d_state
    b2 = y_bc[..., :gds].reshape(*lead, s.n_groups, s.d_state)
    c2 = y_bc[..., gds:].reshape(*lead, s.n_groups, s.d_state)
    grp = torch.arange(h0, h0 + nh, device=y_bc.device) // (
        cfg.n_ssm_heads // s.n_groups)
    return b2.index_select(-2, grp), c2.index_select(-2, grp)


def mamba_seq(cfg: ModelConfig, p: Dict, xb: torch.Tensor, bcb: torch.Tensor,
              dtb: torch.Tensor, valid: torch.Tensor, remat: bool = False,
              h0: int = 0):
    """The Mamba2 mixer between its projections over whole rows from zero
    state (the JAX model's ``_seq``): the causal convs and the chunked SSD,
    before the gated norm (``_gated_out``).  xb: [B, S, di']; bcb: [B, S,
    2*g*ds]; dtb: [B, S, nh']; ``valid`` [B, S] (``dt = 0`` elsewhere):
    ``nh'`` heads from head ``h0`` and their ``di' = nh' * hd`` channels,
    every head on one card, a rank's own under a mesh (``p`` its shards).
    Returns (out [B, S, di'], h [B, nh', hd, ds], conv_x, conv_bc
    states)."""
    s = cfg.ssm
    B, S = xb.shape[:2]
    nh = dtb.shape[-1]
    y_x, cx = M.causal_conv(xb, p["conv_x"], p["conv_bx"], None)
    y_bc, cbc = M.causal_conv(bcb, p["conv_bc"], p["conv_bbc"], None)
    y_x, y_bc = F.silu(y_x), F.silu(y_bc)
    xs = y_x.reshape(B, S, nh, s.head_dim)
    b2, c2 = _expand_bc(cfg, y_bc, (B, S), h0, nh)
    dtv = F.softplus(dtb.float() + p["dt_bias"].float())
    dtv = dtv * valid[..., None].float()                     # pad -> no-op
    A = -torch.exp(p["a_log"].float())
    y, h = M.ssd_chunked(xs, dtv, A, b2, c2, s.chunk, remat=remat)
    y = y + p["d_skip"].to(y.dtype)[None, None, :, None] * xs
    y = y.reshape(B, S, nh * s.head_dim)
    return y, h, cx, cbc


def mamba_step(cfg: ModelConfig, p: Dict, xd: torch.Tensor,
               bcd: torch.Tensor, dtd: torch.Tensor, cache: Dict, mesh=None,
               h0: int = 0) -> torch.Tensor:
    """One decode step of the Mamba2 mixer between its projections, before
    the gated norm, in place on the state rows ``[0, B)`` of ``cache``
    (``h``, ``conv_x``, ``conv_bc``).  xd: [B, 1, di']; bcd: [B, 1,
    2*g*ds]; dtd: [B, 1, nh'] (``mamba_seq``'s heads).  ``dt`` rounds to
    the activation dtype before the decay, as in the JAX model.  Under a
    ``mesh``, a mixer whole on every rank whose ``conv_x`` rows are cut by
    d_inner (a head count that does not divide "model", a d_inner that
    does) gathers them over "model" first and writes back its own slice.
    Returns out [B, 1, di']."""
    s = cfg.ssm
    B = xd.shape[0]
    nh = dtd.shape[-1]
    cx0 = cache["conv_x"][:B]
    if cx0.shape[-1] < xd.shape[-1]:
        cx0 = SH.all_gather(cx0, "model", mesh, dim=2)
    y_x, cx = M.causal_conv(xd, p["conv_x"], p["conv_bx"], cx0)
    y_bc, cbc = M.causal_conv(bcd, p["conv_bc"], p["conv_bbc"],
                              cache["conv_bc"][:B])
    y_x, y_bc = F.silu(y_x[:, 0]), F.silu(y_bc[:, 0])
    xs = y_x.reshape(B, nh, s.head_dim)
    b2, c2 = _expand_bc(cfg, y_bc, (B,), h0, nh)
    dtv = F.softplus(dtd[:, 0].float() + p["dt_bias"].float())
    A = -torch.exp(p["a_log"].float())
    y, h = M.ssd_step(cache["h"][:B], xs, dtv.to(xs.dtype), A, b2, c2)
    y = y + p["d_skip"].to(y.dtype)[None, :, None] * xs
    _write_state(cache, slice(0, B), (h, cx, cbc), mesh)
    return y.reshape(B, 1, nh * s.head_dim)


def _write_state(cache: Dict, rows: slice, states: tuple, mesh) -> None:
    """In place: the state rows ``h``, ``conv_x``, ``conv_bc`` at ``rows``;
    a state wider than its leaf (the whole mixer's ``conv_x`` over rows
    cut by d_inner) writes this rank's slice of its channels."""
    for name, v in zip(("h", "conv_x", "conv_bc"), states):
        c = cache[name]
        w = c.shape[-1]
        if v.shape[-1] > w:
            i = mesh.coords["model"]
            v = v[..., i * w:(i + 1) * w]
        c[rows] = v.to(c.dtype)


def _mamba_apply(cfg: ModelConfig, p: Dict, lr: Dict, plan: _Plan,
                 x: torch.Tensor, cache: Optional[Dict],
                 mesh=None) -> torch.Tensor:
    """The Mamba2 layer over every bucket (``_mamba_apply`` of the JAX
    model); ``cache``: the layer's state rows ``h`` [rows, nh, hd, ds],
    ``conv_x`` [rows, K-1, di] and ``conv_bc`` [rows, K-1, 2*g*ds] (None
    for an ft-only batch).  The ft bucket runs from zero state; prefill
    runs from zero state too and writes its final state at rows ``[Bd, Bd
    + Bp)``; decode reads and writes rows ``[0, Bd)``.  A prefill row's
    conv state is the last ``K-1`` inputs of its padded bucket row, pad
    tokens included, as in the JAX model (ROADMAP Queue 3); its SSM state
    is exact, since ``dt = 0`` on pad tokens.  The gated norm runs once,
    over the merged stream.

    Under a ``mesh`` (``_sharded_forward``), where the SSM heads divide
    "model", a rank runs its own heads and their d_inner channels:
    ``in_z`` / ``in_x`` column-parallel in one ``dense_col``, ``in_bc``
    whole, ``in_dt``, the conv, the SSD and the state rows ``h`` /
    ``conv_x`` its heads' (``conv_bc`` whole), the gated norm's mean of
    squares over the whole d_inner (``gated_sum_sq``: one fp32 all-reduce
    of a [T] vector), ``out_proj`` row-parallel.  Where they do not
    divide, the leaves are whole and every rank runs the whole mixer
    (``mamba_step`` gathers a ``conv_x`` row cut by d_inner).  ``in_bc``
    and ``in_dt`` go through the same ``dense_col`` as ``in_z`` / ``in_x``
    (``_ssm_reads``), so that under a gradient the input's gradient from
    B/C and dt is summed over "model" with the rest where each rank reads
    them for its own heads."""
    xn = L.rms_norm(x, p["ln1"], cfg.rms_eps)
    if mesh is None:
        z_all = dense(xn, p["in_z"], None, lr.get("in_z"), plan.route)
        x_all = dense(xn, p["in_x"], None, lr.get("in_x"), plan.route)
        bc_all = xn @ p["in_bc"].to(xn.dtype)                       # [T, 2gds]
        dt_all = xn @ p["in_dt"].to(xn.dtype)                       # [T, nh']
    else:
        cut = p["in_x"].shape[1] < cfg.d_inner
        read = _read(cut, False)
        z_all, x_all, bc_all, dt_all = dense_col(
            xn, [(p[w], None, lr.get(w), read) for w in ("in_z", "in_x")]
            + [(p[w], None, None, r)
               for w, r in zip(("in_bc", "in_dt"), _ssm_reads(cut))],
            plan.route, mesh)                      # [T, di'], [T, 2gds, nh']
    nh = dt_all.shape[1]
    h0 = mesh.coords["model"] * nh if nh < cfg.n_ssm_heads else 0
    zf, zp, zd = plan.split(z_all)
    xf, xp, xd = plan.split(x_all)
    bf, bp, bd = plan.split(bc_all)
    df, dp, dd = plan.split(dt_all)
    # serving rows carry no gradient, and the state writes stay out of the
    # graph
    zp, xp, bp, dp, zd, xd, bd, dd = (
        t if t is None else t.detach() for t in (zp, xp, bp, dp, zd, xd,
                                                 bd, dd))
    outs = [None, None, None]
    if zf is not None:           # fine-tune / eval: from zero state
        outs[0] = mamba_seq(cfg, p, xf, bf, df, plan.ft_valid, remat=True,
                            h0=h0)[0]
    if zp is not None:           # prefill: from zero state, rows [Bd, Bd+Bp)
        outs[1], h, cx, cbc = mamba_seq(cfg, p, xp, bp, dp, plan.pf_valid,
                                        h0=h0)
        _write_state(cache, slice(plan.Bd, plan.Bd + plan.Bp), (h, cx, cbc),
                     mesh)
    if zd is not None:           # decode: rows [0, Bd) in place
        if plan.Sd > 1:
            raise NotImplementedError(
                "mamba decode state cannot roll back rejected drafts; "
                "speculative verify chunks are attention-only")
        # the state advances once a step: a recompute takes the output
        outs[2] = _once(plan, lambda: mamba_step(cfg, p, xd, bd, dd, cache,
                                                 mesh, h0))
    y = _gated_out(_merge_flat(plan, *outs), _merge_flat(plan, zf, zp, zd),
                   p, mesh, cfg.d_inner)
    if mesh is None:
        return x + dense(y, p["out_proj"], None, lr.get("out_proj"),
                         plan.route)
    return x + dense_row(y, p["out_proj"], lr.get("out_proj"), plan.route,
                         mesh, whole=nh == cfg.n_ssm_heads
                         and mesh.shape["model"] > 1)


def _ssm_reads(cut: bool) -> tuple:
    """How the ranks read ``in_bc`` / ``in_dt``'s outputs (``dense_col``'s
    ``read``): where the SSM heads are cut, ``in_bc`` is whole and each
    rank expands B/C for its own heads (``"differ"``) and ``in_dt`` holds
    the rank's heads (``"cut"``), so the input's gradient from both is a
    summand a rank; where every rank runs the whole mixer, both are read
    alike."""
    return ("differ", "cut") if cut else ("alike", "alike")


def gated_sum_sq(g: torch.Tensor, mesh) -> torch.Tensor:
    """The fp32 sum of squares of each row of ``g`` [T, di/m] over the
    whole d_inner: this rank's slice's, summed over "model" in one
    all-reduce of a [T] vector.  Each rank applies the sum to its own
    slice of d_inner, so under a gradient its adjoint sums every rank's
    gradient (``all_reduce_grad(differ=True)``)."""
    return SH.all_reduce_grad(g.float().pow(2).sum(-1), "model", mesh,
                              differ=True)


def _gated_out(y: torch.Tensor, z: torch.Tensor, p: Dict, mesh=None,
               d_inner: int = 0) -> torch.Tensor:
    """Mamba2's gated RMSNorm: norm(y * silu(z)) over d_inner.  Rows cut by
    d_inner over "model" (``y`` [T, di/m]) take their mean of squares from
    ``gated_sum_sq``."""
    g = y * F.silu(z)
    if mesh is None or g.shape[-1] == d_inner:
        return L.rms_norm(g, p["mnorm"])
    return L.rms_norm(g, p["mnorm"],
                      ms=(gated_sum_sq(g, mesh) / d_inner)[..., None])


def _ffn_apply(cfg: ModelConfig, li: int, p: Dict, lr: Dict, plan: _Plan,
               x: torch.Tensor, mesh=None, fsdp: bool = False,
               own: Optional[torch.Tensor] = None):
    """The dense SwiGLU, or on a MoE layer the routed experts
    (``moe.moe_apply``) plus the shared expert through ``dense`` with its
    LoRA; a layer with no FFN (no ``ln2``: ``mamba2-1.3b``) returns ``x``.
    Under a ``mesh``, ``wg``/``wu`` are column-parallel and ``wd``
    row-parallel, and the routed experts go through
    ``moe_dist.moe_apply_auto`` (``own``: its token mask for the aux
    statistics).  Returns (x + y, the layer's router aux loss)."""
    if "ln2" not in p:
        return x, None
    xn = L.rms_norm(x, p["ln2"], cfg.rms_eps)
    if mesh is not None:
        if is_moe(cfg, li):
            y, aux = moe_apply_auto(xn, p, cfg.moe, fsdp=fsdp, own=own)
            names = ("shared_wg", "shared_wu", "shared_wd")
        else:
            y, aux = None, None
            names = ("wg", "wu", "wd")
        if names[0] in p:
            g, u = dense_col(xn, [(p[n], None, lr.get(n), "cut")
                                  for n in names[:2]], plan.route, mesh)
            ys = dense_row(F.silu(g) * u, p[names[2]], lr.get(names[2]),
                           plan.route, mesh)
            y = ys if y is None else y + ys
        return x + y, aux
    if not is_moe(cfg, li):
        g = dense(xn, p["wg"], None, lr.get("wg"), plan.route)
        u = dense(xn, p["wu"], None, lr.get("wu"), plan.route)
        y = dense(F.silu(g) * u, p["wd"], None, lr.get("wd"), plan.route)
        return x + y, None
    y, aux = moe_apply(xn, p, cfg.moe)
    if "shared_wg" in p:
        g = dense(xn, p["shared_wg"], None, lr.get("shared_wg"), plan.route)
        u = dense(xn, p["shared_wu"], None, lr.get("shared_wu"), plan.route)
        y = y + dense(F.silu(g) * u, p["shared_wd"], None,
                      lr.get("shared_wd"), plan.route)
    return x + y, aux


# ---------------------------------------------------------------------------
# the layer stack, one period at a time: remat and the sequence-sharded carry
# ---------------------------------------------------------------------------

class _Tape:
    """The serving rows' stateful work of one rematerialised period, run
    once.  The first run of the period (the forward) records each
    ``_once`` call's output in call order; every later run (the recompute
    in the backward) hands them back in the same order and runs nothing.
    The JAX period is pure (the cache rides in the scan carry, and
    ``jax.checkpoint`` recomputes from the saved input cache); the port's
    writes the cache in place, so a Mamba decode step run again would
    advance its state a second time and give the period's later layers
    other serving-row states, which the MoE router reads beside the ft
    rows.  The other cache writes (K/V slots and prompt rows, MLA's
    latent, a Mamba prefill's final state, the cross rows) write the same
    values again from the same inputs and need no tape."""

    def __init__(self):
        self.outs: list = []
        self.runs = 0
        self.i = 0

    def begin(self) -> None:
        self.runs += 1
        self.i = 0

    def once(self, run):
        if self.runs > 1:
            out = self.outs[self.i]
            self.i += 1
            return out
        out = run()
        self.outs.append(out)
        return out


def _once(plan: _Plan, run):
    """``run()``, a serving bucket's stateful sublayer (no gradient), once a
    step: through the running period's ``_Tape`` under remat."""
    return run() if plan.tape is None else plan.tape.once(run)


def _run_periods(cfg: ModelConfig, plan: _Plan, x: torch.Tensor, layer,
                 remat: bool, seq=None, axes=None):
    """The stream ``x`` [T, d] through every layer, one period
    (``cfg.pattern``: one layer for the dense decoders, 8 for jamba) at a
    time; ``layer(li, x)`` -> (x, the layer's router aux loss or None).
    Returns (x, the summed aux loss).

    With ``remat`` (a forward with gradient) each period runs under
    ``torch.utils.checkpoint`` (non-reentrant), as JAX's scan body under
    ``jax.checkpoint``: the period's one saved tensor is its input carry,
    and the backward runs it again to rebuild the rest.  Early stopping is
    off, so the recompute runs the whole period and issues every
    collective of it, in the forward's order, on every rank.  A serving
    row's stateful work runs once (``_Tape``), and weights made inside a
    layer (int8 dequant, an FSDP gather) are made again.

    With ``seq`` (``distributed.sharding.SeqShard``, the train step's
    ``act_constraint`` under a mesh) the carry between periods is this
    rank's block of the tokens over ``axes``: the embedding's output is
    cut, each period starts by gathering the blocks and ends by cutting,
    and the last block is gathered for the head.  Under remat the saved
    carry is then the block."""
    from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop
    n_layers, P, T = cfg.n_layers, len(cfg.pattern), x.shape[0]
    zero = lambda: torch.zeros((), dtype=torch.float32, device=x.device)
    aux_loss = zero()
    if seq is not None:
        x = seq.cut(x, axes)
    for p0 in range(0, n_layers, P):
        tape = _Tape() if remat else None

        def period(xc, p0=p0, tape=tape):
            plan.tape = tape
            if tape is not None:
                tape.begin()
            try:
                xx = xc if seq is None else seq.whole(xc, axes, T)
                aux = zero()
                for li in range(p0, min(p0 + P, n_layers)):
                    xx, a = layer(li, xx)
                    if a is not None:
                        aux = aux + a
                return (xx if seq is None else seq.cut(xx, axes)), aux
            finally:
                plan.tape = None

        if remat:
            with set_checkpoint_early_stop(False):
                x, aux = checkpoint(period, x, use_reentrant=False,
                                    preserve_rng_state=False)
        else:
            x, aux = period(x)
        aux_loss = aux_loss + aux
    return (x if seq is None else seq.whole(x, axes, T)), aux_loss


# ---------------------------------------------------------------------------
# unified forward (Algorithm 1, serving buckets)
# ---------------------------------------------------------------------------

def unified_forward(cfg: ModelConfig, params: Dict, batch: UnifiedBatch,
                    cache: Optional[Dict] = None, *,
                    loras: Optional[Dict] = None,
                    lora_scale: Optional[torch.Tensor] = None,
                    block_t: int, attn_chunk: int = 0,
                    return_ft_logits: bool = False, remat: bool = False,
                    act_constraint: Optional[SH.SeqShard] = None
                    ) -> ModelOut:
    """One joint forward over the fine-tune, prefill and decode buckets.
    ``block_t`` is the flow planner's SMLM tile (``FlowConfig.block_t``).
    The ``cache`` is updated in place and returned in ``ModelOut.cache``;
    a batch of ft rows only may pass ``cache=None``.  Fine-tune rows give
    the shifted per-row CE loss (``ft_loss_sum``, ``ft_tok_count``).
    ``remat`` (with a gradient; else it changes nothing) recomputes each
    layer period in the backward (``_run_periods``); ``act_constraint``
    (``distributed.sharding.act_constraint_fn(mesh)``) cuts the carry
    between periods by tokens under a mesh and is the identity without
    one, as JAX's sharding constraint is on one device."""
    check_supported(cfg)
    mesh = SH.ambient_mesh()
    if mesh is not None:
        return _sharded_forward(cfg, mesh, SH.ambient_strategy(), params,
                                batch, cache, loras, lora_scale, block_t,
                                attn_chunk, return_ft_logits,
                                SH.ambient_cache_strategy(), remat,
                                act_constraint)
    plan = _Plan(cfg, batch, lora_scale, block_t)
    index = layer_index(cfg)
    if (batch.pf is not None or batch.dec is not None) and cache is None:
        raise ValueError("prefill/decode buckets require a cache")
    if plan.Bd and batch.dec.block_tables is not None and "k" in cache:
        autotune.load_card_table(cache["k"].device)   # once, on a card
        # one split choice per forward, keyed on the kernels' own grid: one
        # thread block per (request, KV head), where the JAX model counts a
        # TPU grid cell per query head (h/g times more)
        plan.num_splits = autotune.choose(
            cfg.hd, cache["k"].shape[2], batch.dec.block_tables.shape[1],
            plan.Bd * cfg.n_kv_heads,
            lanes=autotune.effective_lanes(cache["k"].device)).num_splits
    # int8 weight-only serving: embed and the head dequantize here; block
    # leaves dequantize per layer inside the loop (a MoE layer's expert
    # stacks only at the routed experts), so device memory holds int8 and
    # at most one layer's dequantized weights at a time
    dtype = params["final_norm"].dtype
    quantized = quant.has_q8(params)
    if quantized:
        params = dict(params)
        for key in ("embed", "lm_head", "encoder"):
            if key in params:
                params[key] = quant.dequant_tree(params[key], dtype)
    if any(i[2] is not None for i in index):
        _cross_sources(cfg, params, plan, dtype)
    x = _embed(cfg, params["embed"], _tokens(batch))               # [T, d]

    lora_layers = (loras["layers"] if loras is not None
                   else [{} for _ in range(cfg.n_layers)])

    def layer(li, x):
        p, lr = params["layers"][li], lora_layers[li]
        if quantized:
            p = {k: (quant.dequant_leaf(v, dtype)
                     if quant.is_q8(v) and k not in EXPERT_STACKS else v)
                 for k, v in p.items()}
        lc = None if cache is None else layer_cache(cfg, cache, li, index)
        if index[li][0] == "mamba":
            x = _mamba_apply(cfg, p, lr, plan, x, lc)
        else:
            x = _attn_apply(cfg, p, lr, plan, x, lc, attn_chunk)
        if index[li][2] is not None:
            x = _cross_apply(cfg, p, lr, plan, x, lc, attn_chunk)
        return _ffn_apply(cfg, li, p, lr, plan, x)

    x, aux_loss = _run_periods(cfg, plan, x, layer,
                               remat and _with_grad(loras))

    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return _outputs(cfg, plan, batch, x, params["final_norm"], head, cache,
                    aux_loss, return_ft_logits)


def _tokens(batch: UnifiedBatch) -> torch.Tensor:
    """The flat stream's token ids: ft rows, then prefill, then decode."""
    return torch.cat([b.tokens.reshape(-1) for b in (batch.ft, batch.pf,
                                                     batch.dec)
                      if b is not None]).long()


def _embed(cfg: ModelConfig, emb: torch.Tensor, toks: torch.Tensor,
           mesh=None) -> torch.Tensor:
    """The rows of ``emb`` at ``toks``.  Under a mesh whose "model" axis
    splits the vocab, ``emb`` is this rank's rows [V/m, d]: a masked local
    lookup (zeros for another rank's tokens) summed over "model"."""
    if mesh is None or emb.shape[0] == cfg.vocab:
        return emb[toks]
    v0 = mesh.coords["model"] * emb.shape[0]
    local = toks - v0
    hit = (local >= 0) & (local < emb.shape[0])
    x = emb[local.clamp(0, emb.shape[0] - 1)] * hit[:, None].to(emb.dtype)
    return SH.all_reduce(x, "model", mesh)


def _outputs(cfg: ModelConfig, plan: _Plan, batch: UnifiedBatch,
             x: torch.Tensor, final_norm: torch.Tensor, head: torch.Tensor,
             cache: Optional[Dict], aux_loss: torch.Tensor,
             return_ft_logits: bool, mesh=None,
             split: Optional[Dict] = None) -> ModelOut:
    """The final norm and the head over the stream's buckets: decode and
    prefill logits, and the ft rows' shifted per-row CE.  Under a mesh
    ``head`` may be this rank's vocab columns [d, V/m]: the logits are
    all-gathered over "model" and the CE takes a vocab-parallel logsumexp
    and label pick; a bucket whose rows ``split`` says are cut over the
    batch axes is all-gathered over them.  With no mesh both are
    whole."""
    x = L.rms_norm(x, final_norm, cfg.rms_eps)
    vocab_split = mesh is not None and head.shape[1] != cfg.vocab
    if vocab_split:
        # a replicated x entering the vocab-parallel head
        x = SH.sum_grad(x, "model", mesh)

    def rows_whole(t, name):
        if split and split[name]:
            from repro_torch.launch.mesh import batch_axes
            # every rank reads the gathered rows alike: "take my rows"
            return SH.all_gather_grad(t, batch_axes(mesh), mesh, dim=0)
        return t

    def vocab_whole(t):
        return SH.all_gather(t, "model", mesh, dim=t.ndim - 1) \
            if vocab_split else t

    xf, xp, xd = plan.split(x)
    ft_loss = ft_cnt = ft_logits = pf_logits = dec_logits = None
    # the serving rows' logits carry no gradient (the loss reads ft rows)
    if xd is not None:
        # [Bd, V] for plain decode; [Bd, Sd, V] for verify chunks (one
        # next-token distribution per chunk position, the acceptance oracle)
        xd = xd.detach()
        dec_logits = rows_whole(vocab_whole(SH.matmul(
            xd[:, 0] if plan.Sd == 1 else xd, head)), "dec")
    if xp is not None:
        last = (batch.pf.length.long() - 1).clamp(min=0)
        pf_logits = rows_whole(vocab_whole(SH.matmul(
            xp.detach()[torch.arange(plan.Bp, device=x.device), last],
            head)), "pf")
    if xf is not None:
        ft = batch.ft
        logits = SH.matmul(xf.reshape(-1, cfg.d_model), head
                           ).reshape(plan.Bf, plan.Sf, -1)
        if return_ft_logits:
            ft_logits = rows_whole(vocab_whole(logits.detach()), "ft")
        lg = logits[:, :-1].float()
        lbl = ft.labels[:, 1:].long()
        valid = (lbl != -100) & ft.mask[:, 1:]
        if vocab_split:
            # each rank holds columns [v0, v0 + V/m); the max only shifts
            # the exponent and takes no gradient
            v0 = mesh.coords["model"] * lg.shape[-1]
            gmax = SH.all_reduce(lg.detach().amax(-1).contiguous(), "model",
                                 mesh, op="max")
            sumexp = torch.exp(lg - gmax[..., None]).sum(-1)
            mine = (lbl >= v0) & (lbl < v0 + lg.shape[-1])
            picked = lg.gather(-1, (lbl - v0).clamp(0, lg.shape[-1] - 1)[
                ..., None])[..., 0] * mine.float()
            # every rank reads the sums alike: the identity as the adjoint
            both = SH.all_reduce_grad(torch.stack([sumexp, picked]), "model",
                                      mesh)
            lse, picked = torch.log(both[0]) + gmax, both[1]
        else:
            lse = torch.logsumexp(lg, dim=-1)
            picked = lg.gather(-1, lbl.clamp(min=0)[..., None])[..., 0]
        ce = torch.where(valid, lse - picked,
                         torch.zeros((), device=x.device))
        ft_loss = rows_whole(ce.sum(dim=1), "ft")
        ft_cnt = rows_whole(valid.sum(dim=1).float(), "ft")
    return ModelOut(ft_loss_sum=ft_loss, ft_tok_count=ft_cnt,
                    ft_logits=ft_logits, pf_logits=pf_logits,
                    dec_logits=dec_logits, cache=cache, aux_loss=aux_loss)


# ---------------------------------------------------------------------------
# the forward under a mesh (explicit SPMD)
# ---------------------------------------------------------------------------

def _with_grad(loras: Optional[Dict]) -> bool:
    """A forward that differentiates the bank (the train step)."""
    return torch.is_grad_enabled() and loras is not None and any(
        t.requires_grad for t in tree_leaves(loras))


def check_shardable(cfg: ModelConfig, mesh, batch: UnifiedBatch,
                    loras: Optional[Dict] = None) -> None:
    """What the sharded forward runs, or a ``ValueError`` that names the
    case: GQA attention (any head counts: the head-dim and sequence cache
    layouts), MLA (heads dividing the model axis) or Mamba2 mixers, alone
    or in one stack (jamba), on dense rows, with dense or MoE FFNs,
    cross-attention layers and an encoder, sliding windows (GQA and MLA),
    in bf16, fp32 or with int8 leaves.  With a gradient (the train step):
    GQA attention and Mamba2 mixers with dense FFNs (or none), alone or in
    one stack, cross-attention layers and an encoder, sliding windows, in
    bf16, fp32 or with int8 leaves; MoE and MLA are refused."""
    where = f"under a {dict(mesh.shape)} mesh"
    if _with_grad(loras):
        later = [what for what, on in (
            ("MoE", any(is_moe(cfg, li) for li in range(cfg.n_layers))),
            ("MLA", cfg.mla is not None)) if on]
        if later:
            raise ValueError(f"{cfg.name}: a forward with gradient {where} "
                             f"over {' and '.join(later)} is a later slice "
                             "(ROADMAP Queue 1, 5b-iii-b)")
    if cfg.mla is not None and cfg.n_heads % mesh.shape["model"]:
        raise ValueError(f"{cfg.name}: MLA's {cfg.n_heads} heads do not "
                         f"divide the model axis {where} (ROADMAP Queue 1, "
                         "5c-ii-b-ii)")
    for name in ("pf", "dec"):
        b = getattr(batch, name)
        if b is not None and b.block_tables is not None:
            raise ValueError(f"a paged {name} bucket {where}: the sharded "
                             "forward runs on dense rows only (ROADMAP "
                             "Queue 1, 5c-ii-b-ii)")
    if batch.dec is not None and batch.dec.tokens.ndim == 2:
        raise ValueError(f"verify chunks {where}: the sharded forward runs "
                         "on dense rows only (ROADMAP Queue 1, 5c-ii-b-ii)")


def local_batch(batch: UnifiedBatch, mesh):
    """This rank's rows of every bucket: the ``batch_axes`` block of a
    bucket whose rows divide them (``batch_shardings``), else the whole
    bucket.  Returns (the local batch, {bucket: split?})."""
    from repro_torch.launch.mesh import axis_size, batch_axes
    bx = batch_axes(mesh)
    n, i = axis_size(mesh, bx), mesh.index(bx)
    out, split = {}, {}
    for name in ("ft", "pf", "dec"):
        b = getattr(batch, name)
        if b is None:
            out[name] = None
            continue
        rows = b.tokens.shape[0]
        split[name] = rows % n == 0 and n > 1
        if not split[name]:
            out[name] = b
            continue
        size = rows // n
        out[name] = type(b)(*(None if t is None else t[i * size:(i + 1) * size]
                              for t in b))
    return UnifiedBatch(**out), split


def _sharded_forward(cfg: ModelConfig, mesh, strategy: Optional[str],
                     params: Dict, batch: UnifiedBatch,
                     cache: Optional[Dict], loras: Optional[Dict],
                     lora_scale: Optional[torch.Tensor], block_t: int,
                     attn_chunk: int, return_ft_logits: bool,
                     cache_strategy: str = "auto", remat: bool = False,
                     act_constraint: Optional[SH.SeqShard] = None
                     ) -> ModelOut:
    """``unified_forward`` as explicit SPMD on one rank of ``mesh``:
    ``params`` / ``loras`` are this rank's shards (``checkpoint.io.
    shard_params`` / ``shard_bank`` under ``strategy``), ``batch`` is the
    whole batch and ``cache`` this rank's shard (``sharding.shard_cache``
    under ``cache_strategy``: its KV rows cut by the KV heads, the head dim
    or the slots, ``sharding.shard_layout``).
    Every bucket's rows are split over the batch axes when they divide them
    (else every data rank runs the whole bucket), and the cache rows with
    them.  The embedding and the head are vocab-parallel over "model"
    (``_embed``, ``_outputs``); the projections are column- or
    row-parallel (``core.lora.dense_col`` / ``dense_row``); under
    ``fsdp_tp`` each layer's "embed"-sharded leaves are all-gathered over
    "data" just before the layer and freed after it (the expert stacks by
    ``moe_apply_auto``), an int8 leaf as its int8 payload and scales
    (``quant.quant_shardings``), dequantized only after the gather (with a
    gradient, inside ``sharding.matmul``: an ``FSDPWeight``).  Cross
    layers and an encoder run their heads column- and row-parallel
    (``_cross_apply``, ``encoder_forward``), MLA its heads with the latent
    sequence cut over "model" (``_mla_apply``; a windowed latent row is a
    rolling row of W slots, W/m a rank), a Mamba2 layer its SSM heads
    (``_mamba_apply``; the layer kind picks the sublayer, as in the plain
    loop).  ``remat`` and ``act_constraint`` as in ``unified_forward``
    (``_run_periods``): under remat ``fsdp_tp`` gathers each layer's
    "data"-cut leaves once more (forward, recompute, backward), and the
    carry between periods is this rank's block of the tokens over "model",
    and over the batch axes too where no bucket was split over them.
    Returns the single-device step's logits, ft loss sums and aux loss on
    every rank, and the local cache."""
    from repro_torch.launch.mesh import batch_axes
    check_shardable(cfg, mesh, batch, loras)
    strategy = strategy or "fsdp_tp"
    fsdp = strategy == "fsdp_tp"
    # with a gradient, a layer's weights cut over "data" stay cut
    # (``sharding.FSDPWeight``): autograd saves the shard, not the gathered
    # leaf
    lazy = fsdp and mesh.shape["data"] > 1 and _with_grad(loras)
    bx = batch_axes(mesh)
    gb, split = local_batch(batch, mesh)
    if (gb.pf is not None or gb.dec is not None) and cache is None:
        raise ValueError("prefill/decode buckets require a cache")
    plan = _Plan(cfg, gb, lora_scale, block_t)
    for name, attr in (("k", "kv_layout"), ("xk", "x_layout")):
        setattr(plan, attr, SH.shard_layout(
            cfg, name, cache[name].shape, mesh, cache_strategy)
            if cache is not None and name in cache else None)
    index = layer_index(cfg)
    dtype = params["final_norm"].dtype
    specs = (quant.quant_shardings(cfg, mesh, strategy)
             if quant.has_q8(params) else
             SH.param_shardings(cfg, mesh, strategy))
    first = mesh.index(bx) == 0

    def data_dim(spec):
        return next((d for d, ax in enumerate(spec) if ax == "data"), None)

    def load(leaf, spec, keep=False):
        """A leaf whole over "data" (the FSDP gather; an int8 leaf's
        payload and scales apart), then dequantized; with ``keep`` under a
        gradient, an ``FSDPWeight`` that ``sharding.matmul`` gathers (an
        int8 leaf's payload and scales, dequantized after each gather)."""
        if quant.is_q8(leaf):
            w = load(leaf["_q8"], spec["_q8"], keep)
            if isinstance(w, SH.FSDPWeight):
                return w._replace(scale=leaf["_qs"], dtype=dtype,
                                  scale_dim=data_dim(spec["_qs"]))
            return quant.dequant_leaf({"_q8": w, "_qs": load(
                leaf["_qs"], spec["_qs"])}, dtype)
        dim = data_dim(spec)
        if dim is None:
            return leaf
        if lazy and keep:
            return SH.FSDPWeight(leaf, dim, mesh)
        return SH.all_gather(leaf, "data", mesh, dim=dim)

    toks = _tokens(gb)
    # the tokens whose router statistics this data group counts: a bucket
    # whole on every data rank is counted by data rank 0 alone
    own = torch.cat([torch.full((n,), bool(split.get(name)) or first,
                                dtype=torch.bool, device=toks.device)
                     for name, n in zip(("ft", "pf", "dec"), plan.sizes)])
    if any(i[2] is not None for i in index):
        enc = specs.get("encoder")
        _cross_sources(cfg, params, plan, dtype, mesh, lambda i, p: {
            k: load(v, enc["layers"][i][k]) for k, v in p.items()})
    x = _embed(cfg, load(params["embed"], specs["embed"]), toks, mesh)

    lora_layers = (loras["layers"] if loras is not None
                   else [{} for _ in range(cfg.n_layers)])

    def layer(li, x):
        sp, lr = specs["layers"][li], lora_layers[li]
        p = {k: (v if k in EXPERT_STACKS or k == "router"
                 else load(v, sp[k], keep=True))
             for k, v in params["layers"][li].items()}
        lc = None if cache is None else layer_cache(cfg, cache, li, index)
        if index[li][0] == "mamba":
            x = _mamba_apply(cfg, p, lr, plan, x, lc, mesh=mesh)
        else:
            x = _attn_apply(cfg, p, lr, plan, x, lc, attn_chunk, mesh=mesh)
        if index[li][2] is not None:
            x = _cross_apply(cfg, p, lr, plan, x, lc, attn_chunk, mesh=mesh)
        return _ffn_apply(cfg, li, p, lr, plan, x, mesh=mesh, fsdp=fsdp,
                          own=own)

    seq = act_constraint
    if seq is not None and seq.mesh is not mesh:
        raise ValueError("act_constraint was made for another mesh than "
                         "the step's")
    x, aux_loss = _run_periods(
        cfg, plan, x, layer, remat and _with_grad(loras), seq,
        None if seq is None else seq.axes(any(split.values())))

    if cfg.tie_embeddings:
        head = load(params["embed"], specs["embed"], keep=True).T
    else:
        head = load(params["lm_head"], specs["lm_head"], keep=True)
    return _outputs(cfg, plan, gb, x, params["final_norm"], head, cache,
                    aux_loss, return_ft_logits, mesh, split)
