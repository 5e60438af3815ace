"""SMLM — segmented multi-LoRA multiplication, CUDA kernel and wrapper.

Replaces the Pallas kernel ``repro/kernels/smlm.py:39`` (``smlm``; body
``_smlm_kernel`` :28, ``pallas_call`` :63)::

    Y[t] = scale[tile] * (X[t] @ A[id[tile]]) @ B[id[tile]]

for a token stream whose ``block_t``-token tiles are adapter-uniform (the
flow planner pads every segment to the tile).

Bound on an H100 SXM: each token tile reads its rows of X, one adapter's
A [d_in, r] and B [r, d_out], and writes its rows of Y, for
2 * T * r * (d_in + d_out) FLOPs — a few FLOPs per byte at r = 8, far under
the card's ~295 FLOP/byte ridge, so memory bandwidth (3.35 TB/s) bounds it.

Design (``csrc/smlm.cu``), two CUDA launches a call.  The shrink runs one
thread-block cluster of 8 blocks a token tile: each block reduces one
eighth of ``d_in`` for the tile's tokens (in bf16: X and A staged by
16-byte ``cp.async`` copies, ``mma.sync`` with the ranks on M and 8 tokens
on N, fp32 accumulators), and after one cluster barrier the cluster sums
the 8 partials in rank order through distributed shared memory (no
atomics: two runs give the same bits) and writes the scaled fp32 shrink,
2 KB a tile at r = 8.  The expand gives a thread 8 columns of 8 tokens: B
read and Y written as 16-byte vectors in bf16, fp32 FMAs; it is launched
as a programmatic dependent of the shrink, so its blocks load B while the
shrink finishes.  So the shrink is computed once a tile, and X, A and B
are read once a tile.  The fused one-launch form (each cluster block
expanding its eighth of ``d_out`` after the barrier) measured slower.  In
bf16 a ``d_in``/``d_out`` that is not a multiple of 8 (or an input off a
16-byte boundary) takes element copies on that side, masked at the edge;
fp32, which only the reduced-size parity runs use, takes element copies
throughout and a CUDA-core shrink.  Any ``block_t`` works (8 tokens at a
time).  A tile with scale 0 writes zeros without reading weights.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import I, P, require
from repro_torch.kernels.ref import smlm_ref as smlm_plain

_ARGS = [P, P, P, P, P, P, P, I, I, I, I, I, I, I, P]
MAX_RANK = 64


def smlm(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
         tile_ids: torch.Tensor, tile_scale: torch.Tensor, *,
         block_t: int) -> torch.Tensor:
    """x: [T, d_in]; a: [n, d_in, r]; b: [n, r, d_out] (same dtype as x);
    tile_ids: [T / block_t] int32; tile_scale: [T / block_t] float32 (0
    disables a tile).  Returns [T, d_out] in x's dtype.  CPU tensors take
    the plain version; CUDA tensors launch the kernel."""
    if x.device.type == "cpu":
        return smlm_plain(x, a, b, tile_ids, tile_scale, block_t)
    require(x.device.type == "cuda", f"no SMLM kernel for {x.device}")
    T, d_in = x.shape
    n, d_in_a, r = a.shape
    d_out = b.shape[-1]
    require(d_in_a == d_in and b.shape == (n, r, d_out),
            f"smlm shapes x{tuple(x.shape)} a{tuple(a.shape)} "
            f"b{tuple(b.shape)}")
    require(a.dtype == x.dtype and b.dtype == x.dtype,
            "smlm takes x, a and b in one dtype")
    require(block_t > 0 and T % block_t == 0,
            f"T={T} is not a multiple of block_t={block_t}")
    require(0 < r <= MAX_RANK, f"rank {r} outside [1, {MAX_RANK}]")
    nt = T // block_t
    require(tile_ids.dtype == torch.int32 and tile_ids.shape == (nt,),
            "tile_ids must be int32 [T / block_t]")
    require(tile_scale.dtype == torch.float32 and tile_scale.shape == (nt,),
            "tile_scale must be float32 [T / block_t]")
    build.check_cuda(x, a, b, tile_ids, tile_scale)
    out = torch.empty((T, d_out), dtype=x.dtype, device=x.device)
    # the scaled shrink between the two launches: [tiles][ceil(block_t /
    # 8)][r padded to a power of two >= 4][8] fp32
    rp = next(p for p in (4, 8, 16, 32, 64) if p >= r)
    shrink = torch.empty(nt * -(-block_t // 8) * rp * 8, dtype=torch.float32,
                         device=x.device)
    fn = build.function("smlm", "smlm_launch", _ARGS)
    err = fn(x.data_ptr(), a.data_ptr(), b.data_ptr(), tile_ids.data_ptr(),
             tile_scale.data_ptr(), shrink.data_ptr(), out.data_ptr(), T, n,
             d_in, r, d_out, block_t, build.dtype_code(x),
             build.stream_of(x))
    build.check(err, "smlm")
    smlm.launches += 1
    return out


smlm.launches = 0
