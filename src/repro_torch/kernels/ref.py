"""Plain PyTorch versions of the four serving kernels, with the signatures and
layouts of ``repro.kernels.ref``.  They are the CPU path of the kernel
wrappers, the CPU tests' subject, and what ``chip_smoke.py`` holds each CUDA
kernel against on the card."""
from __future__ import annotations

import torch

from repro_torch.models.layers import attention


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
