"""Decode attention, CUDA kernels and wrappers: paged (every decode tick of
the paged layout) and dense-row (every decode tick of the dense layout).

Replace the Pallas kernels ``repro/kernels/decode_attn.py:154``
(``paged_decode_attention``; body ``_paged_decode_kernel`` :117,
``pallas_call`` :199): one query per request over its block table, keys
valid for ``j <= pos``; and ``repro/kernels/decode_attn.py:67``
(``decode_attention``; body ``_decode_kernel`` :23, ``pallas_call`` :103):
one query per request over its dense cache row of S slots, linear or
rolling (slot ``j`` holds position ``j + S*floor((pos - j)/S)`` when
``window > 0``; keys ``0 <= k_pos <= pos``, and ``pos - k_pos < window``).
The Pallas kernel pads the row to a multiple of ``block_k`` with zeros but
reconstructs rolling positions with the unpadded S, so with ``window > 0``
and ``S % block_k != 0`` a padded zero key can enter its softmax; this port
computes the function of ``decode_attention_ref`` (the model's
``_dec_cache_pos``), not that artifact.  The verify kernel of the same file
is ``verify_attn.py``.

Bound on an H100 SXM: each request reads the K and V rows of its valid keys
(2 * keys * g * hd elements) for 4 * h * keys * hd FLOPs — about h/g FLOPs
per byte, so memory bandwidth (3.35 TB/s) bounds both.

Design (``csrc/decode_attn.cu``): the TPU grids (B, h, ...) stream each
K/V tile once per query head; here one block per (request, KV head) serves
all m = h/g query heads of the group from a single read of each K/V row,
copied by 16-byte ``cp.async`` into rings in shared memory.  bf16 decode
with m <= 8, paged and dense, runs the split-key walk of
``csrc/split_walk.cuh`` with one column tile (verify and prefill chunks
take the same walk with more): every warp of the block (eight up to hd
128, four above) walks keys (32-key units dealt in turn) through its own
three-stage ring of 16-key tiles, so up to 16 tiles are in flight a block
instead of one; the products are transposed (``mma.sync`` with the 16 keys
on M and the heads on N: S^T = K Q^T, O^T += V^T P^T, P^T passed on in
registers by ``movmatrix``), and the warps' partials are merged in warp
order in exp2 units at the end.  A paged unit reads the table once; a
dense unit is one run of rows, and the walk's key mask admits the row's
valid slots (a prefix, or a rolling row's arc, whose tiles with no valid
slot are skipped); no slot >= S is read.  bf16 decode with m > 8 runs the
tensor-core query-tile walk of ``csrc/tile_walk.cuh`` (the m heads are the
rows of a one-position tile), fp32 the CUDA-core walk of
``csrc/paged_walk.cuh`` (the heads shared among the warps).  The paged
walks stop at key ``pos``, the linear dense walk at slot ``pos``; the
online softmax runs in fp32; rows with no valid key give 0.  Inactive
paged decode rows (``pos = 0``, null table) read only block 0.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import F, I, P, require
from repro_torch.kernels.ref import decode_attention_ref as decode_plain
from repro_torch.kernels.ref import paged_decode_ref as paged_decode_plain

_ARGS = [P, P, P, P, P, P, I, I, I, I, I, I, F, I, P]
_DENSE_ARGS = [P, P, P, P, P, I, I, I, I, I, I, F, I, P]


def _check_heads(q: torch.Tensor, g: int, hd_k: int) -> None:
    _, h, hd = q.shape
    require(hd_k == hd, "q and k/v head dims differ")
    require(h % g == 0 and h // g <= 32, "need h % g == 0 and h / g <= 32")
    require(hd % 32 == 0 and hd <= 256, "head dim must be 32k <= 256")


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
    require(v_pool.shape == k_pool.shape,
            "k/v pools must be [n_blocks, bs, g, hd]")
    require(k_pool.dtype == q.dtype and v_pool.dtype == q.dtype,
            "q and the pools must share a dtype")
    _check_heads(q, g, hd_k)
    require(block_tables.dtype == torch.int32
            and block_tables.shape == (B, nbt), "tables must be int32 [B, nbt]")
    require(pos.dtype == torch.int32 and pos.shape == (B,),
            "pos must be int32 [B]")
    build.check_cuda(q, k_pool, v_pool, block_tables, pos)
    build.check_vectors(q, k_pool, v_pool)
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


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: torch.Tensor, *, window: int = 0) -> torch.Tensor:
    """q: [B, h, hd]; k/v: [B, S, g, hd] dense cache rows (a rolling buffer
    when ``window > 0``); pos: [B] int32 current positions.  Returns
    [B, h, hd].  CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    if q.device.type == "cpu":
        return decode_plain(q, k, v, pos, window)
    require(q.device.type == "cuda", f"no decode kernel for {q.device}")
    B, h, hd = q.shape
    _, S, g, hd_k = k.shape
    require(k.shape[0] == B and v.shape == k.shape,
            "k/v must be [B, S, g, hd]")
    require(k.dtype == q.dtype and v.dtype == q.dtype,
            "q, k and v must share a dtype")
    _check_heads(q, g, hd_k)
    require(pos.dtype == torch.int32 and pos.shape == (B,),
            "pos must be int32 [B]")
    build.check_cuda(q, k, v, pos)
    build.check_vectors(q, k, v)
    out = torch.empty_like(q)
    fn = build.function("decode_attn", "dense_decode_launch", _DENSE_ARGS)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
             out.data_ptr(), B, h, g, hd, S, int(window), hd ** -0.5,
             build.dtype_code(q), build.stream_of(q))
    build.check(err, "decode_attn")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
