"""Paged prefill attention, CUDA kernel and wrapper (suffix-only prefill).

Replaces the Pallas kernel ``repro/kernels/prefill_attn.py:78``
(``paged_prefill_attention``; body ``_paged_prefill_kernel`` :34,
``pallas_call`` :130): ``Sq`` suffix queries per request at absolute
positions ``cached_len + i`` over a block-table pool; keys valid for
``j <= qi`` and ``j < cached_len + seg_len``; ``seg_len == 0`` rows (with
``cached_len == 0``, as the planner pads) give zeros.

Bound on an H100 SXM: each request reads its K/V blocks up to
``cached_len + seg_len`` once, for about 4 * h * Sq * (cached + seg / 2) * hd
FLOPs.  At the smoke shapes (16-token suffixes over 128 cached tokens) that
is ~2 * Sq * h / g FLOPs per byte, under the ridge, so bytes bound it.

Design (``csrc/prefill_attn.cu``): a suffix of Sq positions has Sq * h/g
query columns (a position's h/g query heads of one KV head).  In bf16, up
to the crossover ``SW_SPLIT_COLS`` of ``csrc/split_walk.cuh`` (128
columns, measured on the card) take that split-key walk: one block of 8
warps per (KV head, request, group of at most 32 columns), each warp
walking 32-key units of the keys its group's last position sees through its
own ring, with the columns on the N side of ``mma.sync``; a request's K/V
is read once per group.  Longer
suffixes take the query-tile walk of ``csrc/tile_walk.cuh`` (the flash
kernel's): one block per 64 / (h/g) positions, K/V read once per tile.  fp32
runs the CUDA-core query-tile walk, one pool block at a time.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import F, I, P, require
from repro_torch.kernels.ref import paged_prefill_ref as paged_prefill_plain

_ARGS = [P, P, P, P, P, P, P, I, I, I, I, I, I, I, F, I, P]
TILE_ROWS = 64      # query rows (positions x heads of a group) per block


def paged_prefill_attention(q: torch.Tensor, k_pool: torch.Tensor,
                            v_pool: torch.Tensor, block_tables: torch.Tensor,
                            cached_len: torch.Tensor, seg_len: torch.Tensor
                            ) -> torch.Tensor:
    """q: [B, Sq, h, hd] (roped at ``cached_len + i``); k_pool/v_pool:
    [n_blocks, bs, g, hd] with the suffix K/V already written; block_tables:
    [B, nbt] int32; cached_len/seg_len: [B] int32.  Returns [B, Sq, h, hd].
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if q.device.type == "cpu":
        return paged_prefill_plain(q, k_pool, v_pool, block_tables,
                                   cached_len, seg_len)
    require(q.device.type == "cuda", f"no prefill kernel for {q.device}")
    B, Sq, h, hd = q.shape
    _, bs, g, hd_k = k_pool.shape
    nbt = block_tables.shape[1]
    require(hd_k == hd and v_pool.shape == k_pool.shape,
            "k/v pools must be [n_blocks, bs, g, hd]")
    require(k_pool.dtype == q.dtype and v_pool.dtype == q.dtype,
            "q and the pools must share a dtype")
    require(h % g == 0 and TILE_ROWS % (h // g) == 0,
            f"h / g must divide {TILE_ROWS}")
    require(hd % 32 == 0 and hd <= 256, "head dim must be 32k <= 256")
    require(block_tables.dtype == torch.int32
            and block_tables.shape == (B, nbt), "tables must be int32 [B, nbt]")
    for name, t in (("cached_len", cached_len), ("seg_len", seg_len)):
        require(t.dtype == torch.int32 and t.shape == (B,),
                f"{name} must be int32 [B]")
    build.check_cuda(q, k_pool, v_pool, block_tables, cached_len, seg_len)
    build.check_vectors(q, k_pool, v_pool)
    out = torch.empty_like(q)
    fn = build.function("prefill_attn", "paged_prefill_launch", _ARGS)
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             block_tables.data_ptr(), cached_len.data_ptr(),
             seg_len.data_ptr(), out.data_ptr(), B, Sq, h, g, hd, bs, nbt,
             hd ** -0.5, build.dtype_code(q), build.stream_of(q))
    build.check(err, "prefill_attn")
    paged_prefill_attention.launches += 1
    return out


paged_prefill_attention.launches = 0
