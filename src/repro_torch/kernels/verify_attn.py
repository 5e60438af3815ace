"""Paged verify attention, CUDA kernel and wrapper (speculative verify ticks).

Replaces the Pallas kernel ``repro/kernels/decode_attn.py:254``
(``paged_verify_attention``; body ``_paged_verify_kernel`` :215,
``pallas_call`` :302): an ``Sq``-token chunk per request (current token plus
drafts) at positions ``pos .. pos + Sq - 1``, keys valid for ``j <= pos + i``
and ``j < pos + lens``.

Bound on an H100 SXM: each request reads the K and V rows of keys ``0 ..
pos + lens - 1`` (2 * (pos + lens) * g * hd elements) for about 4 * h * Sq *
(pos + lens) * hd FLOPs, about Sq * h/g FLOPs per byte, so memory bandwidth
(3.35 TB/s) bounds it at the chunk widths speculation uses.

Design (``csrc/verify_attn.cu``): the TPU grid (B, h, nbt) streams each
K/V block once per query head; here one thread block per (request, KV head)
serves all h/g query heads x Sq chunk positions of the group (Sq * h/g
columns) from a single read of each block.  In bf16 a chunk of up to the
crossover ``SW_SPLIT_COLS`` of ``csrc/split_walk.cuh`` (128 columns,
measured on the card; the serving chunk is 5 positions x 4 heads) takes
that split-key walk, one block per group of at most 32 columns: 8 warps
each walk 32-key units of the keys through their own 16-byte ``cp.async``
ring, with the keys on the M side of ``mma.sync`` and the columns on N
(ceil(columns / 8) column tiles), each column masked at its own position,
and the warps' partials merged at the end; above hd 128 a block holds fewer
column tiles and the columns take more groups.  Wider bf16 chunks take the tensor-core query-tile walk of
``csrc/tile_walk.cuh`` (at most 64/(h/g) positions a tile), fp32 the
CUDA-core walk of ``csrc/paged_walk.cuh`` (several rows a warp; more than 64
rows take several thread blocks).  The walk stops at the key ``pos + lens -
1``; the online softmax runs in fp32; rows with no valid key (``pos = lens
= 0``) give exact zeros.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import F, I, P, require
from repro_torch.kernels.ref import paged_verify_ref as paged_verify_plain

_ARGS = [P, P, P, P, P, P, P, I, I, I, I, I, I, I, F, I, P]


def check_chunk_args(q: torch.Tensor, k_pool: torch.Tensor,
                     v_pool: torch.Tensor, block_tables: torch.Tensor,
                     pos: torch.Tensor, lens: torch.Tensor) -> None:
    """The shapes, types and placement the chunk kernels (verify, split-K)
    take; raises ``ValueError`` on anything else."""
    B, Sq, h, hd = q.shape
    _, bs, g, hd_k = k_pool.shape
    nbt = block_tables.shape[1]
    require(hd_k == hd and v_pool.shape == k_pool.shape,
            "k/v pools must be [n_blocks, bs, g, hd]")
    require(k_pool.dtype == q.dtype and v_pool.dtype == q.dtype,
            "q and the pools must share a dtype")
    require(h % g == 0, "need h % g == 0")
    require(q.dtype != torch.bfloat16 or h // g <= 64,
            "the bf16 walk takes at most 64 query heads per KV head")
    require(hd % 32 == 0 and hd <= 256, "head dim must be 32k <= 256")
    require(block_tables.dtype == torch.int32
            and block_tables.shape == (B, nbt),
            "tables must be int32 [B, nbt]")
    for name, v in (("pos", pos), ("lens", lens)):
        require(v.dtype == torch.int32 and v.shape == (B,),
                f"{name} must be int32 [B]")
    build.check_cuda(q, k_pool, v_pool, block_tables, pos, lens)
    build.check_vectors(q, k_pool, v_pool)


def paged_verify_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_tables: torch.Tensor,
                           pos: torch.Tensor, lens: torch.Tensor
                           ) -> torch.Tensor:
    """q: [B, Sq, h, hd] (roped; the chunk's own K/V already written at
    ``pos .. pos + lens - 1``); k_pool/v_pool: [n_blocks, bs, g, hd];
    block_tables: [B, nbt] int32 (null-padded, negatives read block 0);
    pos/lens: [B] int32.  Returns [B, Sq, h, hd].  CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    if q.device.type == "cpu":
        return paged_verify_plain(q, k_pool, v_pool, block_tables, pos, lens)
    require(q.device.type == "cuda", f"no verify kernel for {q.device}")
    check_chunk_args(q, k_pool, v_pool, block_tables, pos, lens)
    B, Sq, h, hd = q.shape
    _, bs, g, _ = k_pool.shape
    out = torch.empty_like(q)
    fn = build.function("verify_attn", "paged_verify_launch", _ARGS)
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             block_tables.data_ptr(), pos.data_ptr(), lens.data_ptr(),
             out.data_ptr(), B, Sq, h, g, hd, bs, block_tables.shape[1],
             hd ** -0.5, build.dtype_code(q), build.stream_of(q))
    build.check(err, "verify_attn")
    paged_verify_attention.launches += 1
    return out


paged_verify_attention.launches = 0
