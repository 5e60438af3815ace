"""Paged decode attention, CUDA kernel and wrapper (every decode tick).

Replaces the Pallas kernel ``repro/kernels/decode_attn.py:154``
(``paged_decode_attention``; body ``_paged_decode_kernel`` :117,
``pallas_call`` :199): one query per request over its block table, keys
valid for ``j <= pos``.  The dense-row ``decode_attention`` and the verify
kernel of the same file belong to later slices.

Bound on an H100 SXM: each request reads the K and V blocks its table names
up to ``pos`` (2 * (pos + 1) * g * hd elements) for 4 * h * (pos + 1) * hd
FLOPs — about h/g FLOPs per byte, so memory bandwidth (3.35 TB/s) bounds it.

Design (``csrc/decode_attn.cu``): the TPU grid (B, h, nbt) streams each K/V
block once per query head; here one block per (request, KV head) serves all
h/g query heads of the group, one warp each, from a single read of each
block, staged in shared memory as fp32.  The walk stops at the block holding
``pos``; the online softmax runs in fp32; rows with no valid key give 0.
Inactive decode rows (``pos = 0``, null table) read only block 0.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import F, I, P, require
from repro_torch.kernels.ref import paged_decode_ref as paged_decode_plain

_ARGS = [P, P, P, P, P, P, I, I, I, I, I, I, F, I, P]


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_tables: torch.Tensor,
                           pos: torch.Tensor) -> torch.Tensor:
    """q: [B, h, hd]; k_pool/v_pool: [n_blocks, bs, g, hd]; block_tables:
    [B, nbt] int32 (null-padded, negatives read block 0); pos: [B] int32.
    Returns [B, h, hd].  CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
    if q.device.type == "cpu":
        return paged_decode_plain(q, k_pool, v_pool, block_tables, pos)
    require(q.device.type == "cuda", f"no decode kernel for {q.device}")
    B, h, hd = q.shape
    _, bs, g, hd_k = k_pool.shape
    nbt = block_tables.shape[1]
    require(hd_k == hd and v_pool.shape == k_pool.shape,
            "k/v pools must be [n_blocks, bs, g, hd]")
    require(k_pool.dtype == q.dtype and v_pool.dtype == q.dtype,
            "q and the pools must share a dtype")
    require(h % g == 0 and h // g <= 32, "need h % g == 0 and h / g <= 32")
    require(hd % 32 == 0 and hd <= 256, "head dim must be 32k <= 256")
    require(block_tables.dtype == torch.int32
            and block_tables.shape == (B, nbt), "tables must be int32 [B, nbt]")
    require(pos.dtype == torch.int32 and pos.shape == (B,),
            "pos must be int32 [B]")
    build.check_cuda(q, k_pool, v_pool, block_tables, pos)
    out = torch.empty_like(q)
    fn = build.function("decode_attn", "paged_decode_launch", _ARGS)
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             block_tables.data_ptr(), pos.data_ptr(), out.data_ptr(), B, h,
             g, hd, bs, nbt, hd ** -0.5, build.dtype_code(q),
             build.stream_of(q))
    build.check(err, "decode_attn")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
