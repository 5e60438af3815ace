"""Plain PyTorch versions of the serving kernels, with the signatures and
layouts of ``repro.kernels.ref`` (and, for split-K, of the partials and the
merge of ``repro.kernels.splitk``).  They are the CPU path of the kernel
wrappers, the CPU tests' subject, and what ``chip_smoke.py`` holds each CUDA
kernel against on the card; nothing on the CUDA main path calls them."""
from __future__ import annotations

import torch

from repro_torch.models.layers import NEG_INF, attention, dec_cache_pos


def _onehot(ids: torch.Tensor, n: int) -> torch.Tensor:
    """[T, n] float one-hot; out-of-range ids give an all-zero row."""
    return (ids.long()[:, None] == torch.arange(n, device=ids.device)
            ).float()


def bgmv_ref(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
             ids: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Per-token multi-LoRA matmul (one-hot form, fp32 accumulate):
    ``y[t] = scale[t] * (x[t] @ a[ids[t]]) @ b[ids[t]]``.
    x: [T, d_in]; a: [n, d_in, r]; b: [n, r, d_out]; ids/scale: [T]."""
    n, d_in, r = a.shape
    onehot = _onehot(ids, n) * scale.float()[:, None]            # [T, n]
    xa = (x.float() @ a.float().permute(1, 0, 2).reshape(d_in, n * r)
          ).reshape(-1, n, r)                                     # [T, n, r]
    xa = xa * onehot[:, :, None]
    y = xa.reshape(-1, n * r) @ b.float().reshape(n * r, -1)
    return y.to(x.dtype)


def smlm_ref(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
             tile_ids: torch.Tensor, tile_scale: torch.Tensor,
             block_t: int) -> torch.Tensor:
    """Tile-segmented multi-LoRA matmul: every ``block_t``-token tile uses
    one adapter id and one scale."""
    ids = torch.repeat_interleave(tile_ids, block_t)
    scale = torch.repeat_interleave(tile_scale, block_t)
    return bgmv_ref(x, a, b, ids, scale)


def _gather_view(pool: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """[B, nbt*bs, g, hd] per-request contiguous view (null entries and
    negatives read block 0, which the masks exclude)."""
    tbl = tables.long().clamp(min=0)
    B, nbt = tbl.shape
    return pool[tbl].reshape(B, nbt * pool.shape[1], *pool.shape[2:])


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        lengths: torch.Tensor, causal: bool = True
                        ) -> torch.Tensor:
    """Masked GQA attention, full-scores form: query ``i`` of request ``b``
    sees keys ``j < lengths[b]`` (and ``j <= i`` when ``causal``); a row
    with no valid key gives 0.  q: [B, S, h, hd]; k/v: [B, T, g, hd];
    lengths: [B].  Returns [B, S, h, hd]."""
    B, S = q.shape[:2]
    T = k.shape[1]
    q_pos = torch.arange(S, device=q.device)[None, :].expand(B, S)
    k_pos = torch.arange(T, device=q.device)[None, :].expand(B, T)
    k_valid = k_pos < lengths.long()[:, None]
    return attention(q, k, v, q_pos=q_pos, k_pos=k_pos, k_valid=k_valid,
                     causal=causal)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         pos: torch.Tensor, window: int = 0) -> torch.Tensor:
    """One query per request over its dense cache row of ``sc`` slots,
    linear or rolling: slot ``j`` holds position ``j + sc * floor((pos -
    j) / sc)`` (``layers.dec_cache_pos``); keys ``0 <= k_pos <= pos`` are
    valid, and ``pos - k_pos < window`` when ``window > 0``.  q: [B, h, hd];
    k/v: [B, sc, g, hd]; pos: [B].  Returns [B, h, hd]."""
    k_pos, k_valid = dec_cache_pos(pos, k.shape[1])
    return attention(q[:, None], k, v, q_pos=pos.long()[:, None],
                     k_pos=k_pos, k_valid=k_valid, causal=True,
                     window=window)[:, 0]


def paged_decode_ref(q: torch.Tensor, k_pool: torch.Tensor,
                     v_pool: torch.Tensor, block_tables: torch.Tensor,
                     pos: torch.Tensor) -> torch.Tensor:
    """One query per request over its block table, keys valid for
    ``j <= pos``.  q: [B, h, hd]; pools: [n_blocks, bs, g, hd];
    block_tables: [B, nbt]; pos: [B].  Returns [B, h, hd]."""
    B = q.shape[0]
    nbt, bs = block_tables.shape[1], k_pool.shape[1]
    j = torch.arange(nbt * bs, device=q.device)[None, :]
    k_pos = j.expand(B, -1)
    k_valid = j <= pos.long()[:, None]
    return attention(q[:, None], _gather_view(k_pool, block_tables),
                     _gather_view(v_pool, block_tables),
                     q_pos=pos.long()[:, None], k_pos=k_pos,
                     k_valid=k_valid, causal=True)[:, 0]


def paged_prefill_ref(q: torch.Tensor, k_pool: torch.Tensor,
                      v_pool: torch.Tensor, block_tables: torch.Tensor,
                      cached_len: torch.Tensor, seg_len: torch.Tensor
                      ) -> torch.Tensor:
    """Suffix-only prefill: ``Sq`` queries per request at absolute positions
    ``cached_len .. cached_len + Sq - 1``; keys valid through
    ``cached_len + seg_len - 1`` and causal by absolute position
    (``seg_len == 0`` rows give zeros).  q: [B, Sq, h, hd]."""
    B, Sq = q.shape[:2]
    nbt, bs = block_tables.shape[1], k_pool.shape[1]
    cached = cached_len.long()
    j = torch.arange(nbt * bs, device=q.device)[None, :]
    k_pos = j.expand(B, -1)
    k_valid = j < (cached + seg_len.long())[:, None]
    q_pos = cached[:, None] + torch.arange(Sq, device=q.device)[None, :]
    return attention(q, _gather_view(k_pool, block_tables),
                     _gather_view(v_pool, block_tables), q_pos=q_pos,
                     k_pos=k_pos, k_valid=k_valid, causal=True)


def paged_verify_ref(q: torch.Tensor, k_pool: torch.Tensor,
                     v_pool: torch.Tensor, block_tables: torch.Tensor,
                     pos: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Verify chunk: ``Sq`` queries per request at positions ``pos .. pos +
    Sq - 1``; keys valid through ``pos + lens - 1`` and causal by position
    (a row with ``pos = lens = 0`` has no valid key and gives zeros).
    q: [B, Sq, h, hd]; pools: [n_blocks, bs, g, hd]; tables: [B, nbt];
    pos/lens: [B].  Returns [B, Sq, h, hd]."""
    return paged_prefill_ref(q, k_pool, v_pool, block_tables, pos, lens)


def splitk_partials_ref(q: torch.Tensor, k_pool: torch.Tensor,
                        v_pool: torch.Tensor, block_tables: torch.Tensor,
                        pos: torch.Tensor, lens: torch.Tensor,
                        num_splits: int):
    """The split-K partials of ``repro.kernels.splitk._splitk_kernel``: the
    table, padded with null entries to ``ns * npb`` (``npb = ceil(nbt /
    ns)``), is cut into ``ns`` runs of ``npb`` blocks; each run gives the
    un-normalized ``acc = sum_j exp(s_j - m) v_j``, its max score ``m``
    (``NEG_INF`` when no key of the run is valid) and ``l = sum_j exp(s_j -
    m)``, in fp32.  Mask as ``paged_verify_ref``.  q: [B, Sq, h, hd].
    Returns ``(acc [B, ns, Sq, h, hd], m [B, ns, Sq, h], l [B, ns, Sq, h])``.
    """
    B, Sq, h, hd = q.shape
    bs, g = k_pool.shape[1], k_pool.shape[2]
    nbt = block_tables.shape[1]
    ns = max(1, int(num_splits))
    npb = -(-nbt // ns)
    tbl = block_tables.long().clamp(min=0)
    if ns * npb > nbt:
        tbl = torch.nn.functional.pad(tbl, (0, ns * npb - nbt))
    k = _gather_view(k_pool, tbl).float()              # [B, ns*npb*bs, g, hd]
    v = _gather_view(v_pool, tbl).float()
    T = ns * npb * bs
    rep = h // g
    k = k.repeat_interleave(rep, dim=2)                # [B, T, h, hd]
    v = v.repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k) * hd ** -0.5
    j = torch.arange(T, device=q.device)
    qi = pos.long()[:, None] + torch.arange(Sq, device=q.device)[None, :]
    mask = (j[None, None, :] <= qi[:, :, None]) \
        & (j[None, None, :] < (pos.long() + lens.long())[:, None, None])
    mask = mask[:, None]                               # [B, 1, Sq, T]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    s = s.reshape(B, h, Sq, ns, npb * bs)
    mk = mask.reshape(B, 1, Sq, ns, npb * bs)
    m = s.amax(-1)                                     # [B, h, Sq, ns]
    p = torch.where(mk, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = p.sum(-1)
    vs = v.reshape(B, ns, npb * bs, h, hd)
    acc = torch.einsum("bhqsk,bskhd->bsqhd", p, vs)
    return (acc, m.permute(0, 3, 2, 1).contiguous(),
            l.permute(0, 3, 2, 1).contiguous())


def lse_merge(o_part: torch.Tensor, m_part: torch.Tensor,
              l_part: torch.Tensor) -> torch.Tensor:
    """Combine split-K partials (``repro.kernels.splitk.lse_merge``): each
    split weighs ``exp(min(m - m_max, 0))``; an empty split (``m =
    NEG_INF``, ``l = 0``) adds nothing, and all-empty rows give zeros
    through the ``1e-30`` clamp.  o_part: [B, ns, Sq, h, hd]; m/l: [B, ns,
    Sq, h], fp32.  Returns [B, Sq, h, hd] fp32."""
    m_max = m_part.amax(1, keepdim=True)
    w = torch.exp(torch.clamp(m_part - m_max, max=0.0))
    l_tot = (l_part * w).sum(1)
    o = (o_part * w[..., None]).sum(1)
    return o / l_tot.clamp(min=1e-30)[..., None]
