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

The gradient (``SMLMFunction``, used when grad mode is on and the stream
carries fine-tune rows) has no Pallas counterpart: JAX differentiates its
plain ``lora_apply_ref``.  Per tile of scale ``s``, ``dX = s dY B^T A^T`` is
SMLM itself with ``a' = B^T`` and ``b' = A^T``, written straight into the
fine-tune rows of dX (``out=``), whose kept shrink ``Gs = s dY B^T`` feeds
the weight gradient ``dA = X^T Gs``, ``dB = S^T dY`` (``S = s X A``, the
forward's kept shrink), computed by ``smlm_wgrad`` (``csrc/smlm_grad.cu``),
segmented per adapter.  Its bound is bytes too (X and dY of the live
tokens read once, r FLOPs a byte at r = 8).  Design: one launch, one block
of four warps per 128-column chunk of dA or dB and bank slot; the block
lists its slot's live tiles, each warp takes every fourth 16-token K step
and streams it through a ``cp.async`` ring of its own, the sums run on the
tensor cores in bf16 (``mma.sync`` with the columns on M, the rank on N,
the tokens on K; fp32 on the CUDA cores), and the block sums its warps in
warp order: no atomics, the same bits on every run.  Splitting a slot's
tiles over a thread-block cluster measured slower at the grad step's
widest shapes; the source lists the slower forms.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import I, P, require
from repro_torch.kernels.ref import pack_shrink, rank_pad, \
    smlm_expand_ref, smlm_ref, smlm_shrink_ref, smlm_wgrad_ref, unpack_shrink

_ARGS = [P, P, P, P, P, P, P, I, I, I, I, I, I, I, P]
_SPLIT_ARGS = [P, P, P, P, P, I, I, I, I, I, I, P]
_WGRAD_ARGS = [P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, P]
MAX_RANK = 64


def smlm(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
         tile_ids: torch.Tensor, tile_scale: torch.Tensor, *,
         block_t: int, keep_shrink: bool = False,
         out: torch.Tensor | None = None):
    """x: [T, d_in]; a: [n, d_in, r]; b: [n, r, d_out] (same dtype as x);
    tile_ids: [T / block_t] int32; tile_scale: [T / block_t] float32 (0
    disables a tile).  Returns [T, d_out] in x's dtype, and with
    ``keep_shrink`` also the scaled shrink ``scale * X A`` as the kernel
    keeps it (``ref.pack_shrink``'s layout; tiles of scale 0 unwritten on
    the card).  ``out``: a contiguous [T, d_out] tensor of x's dtype and
    device (a view may do) that receives the result, which is then returned.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if out is not None:
        require(out.shape == (x.shape[0], b.shape[-1])
                and out.dtype == x.dtype and out.device == x.device
                and out.is_contiguous(),
                f"smlm out{tuple(out.shape)} {out.dtype} {out.device} is not "
                f"a contiguous [{x.shape[0]}, {b.shape[-1]}] {x.dtype} "
                f"{x.device} tensor")
    if x.device.type == "cpu":
        y = smlm_ref(x, a, b, tile_ids, tile_scale, block_t)
        if out is not None:
            y = out.copy_(y)
        if not keep_shrink:
            return y
        return y, pack_shrink(smlm_shrink_ref(x, a, tile_ids, tile_scale,
                                              block_t), block_t)
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
    if out is None:
        out = torch.empty((T, d_out), dtype=x.dtype, device=x.device)
    # the scaled shrink between the two launches: [tiles][ceil(block_t /
    # 8)][r padded to a power of two >= 4][8] fp32
    shrink = torch.empty(nt * -(-block_t // 8) * rank_pad(r) * 8,
                         dtype=torch.float32, device=x.device)
    fn = build.function("smlm", "smlm_launch", _ARGS)
    err = fn(x.data_ptr(), a.data_ptr(), b.data_ptr(), tile_ids.data_ptr(),
             tile_scale.data_ptr(), shrink.data_ptr(), out.data_ptr(), T, n,
             d_in, r, d_out, block_t, build.dtype_code(x),
             build.stream_of(x))
    build.check(err, "smlm")
    smlm.launches += 1
    return (out, shrink) if keep_shrink else out


smlm.launches = 0


def _check_tiles(T: int, r: int, block_t: int, tile_ids: torch.Tensor,
                 tile_scale: torch.Tensor) -> None:
    require(block_t > 0 and T % block_t == 0,
            f"T={T} is not a multiple of block_t={block_t}")
    require(0 < r <= MAX_RANK, f"rank {r} outside [1, {MAX_RANK}]")
    nt = T // block_t
    require(tile_ids.dtype == torch.int32 and tile_ids.shape == (nt,),
            "tile_ids must be int32 [T / block_t]")
    require(tile_scale.dtype == torch.float32 and tile_scale.shape == (nt,),
            "tile_scale must be float32 [T / block_t]")


def smlm_shrink(x: torch.Tensor, a: torch.Tensor, tile_ids: torch.Tensor,
                tile_scale: torch.Tensor, *, block_t: int) -> torch.Tensor:
    """SMLM's first launch alone: the scaled shrink ``scale[tile] * X @
    A[id[tile]]`` as a plain fp32 [T, r] (zeros on tiles of scale 0).  On a
    rank that holds a slice of d_in (x's columns and a's rows) it is that
    slice's partial sum, to be summed over the ranks before
    ``smlm_expand``.  CPU tensors take the plain version; CUDA tensors
    launch ``smlm_shrink_launch`` (``csrc/smlm.cu``)."""
    if x.device.type == "cpu":
        return smlm_shrink_ref(x, a, tile_ids, tile_scale, block_t)
    require(x.device.type == "cuda", f"no SMLM kernel for {x.device}")
    T, d_in = x.shape
    n, d_in_a, r = a.shape
    require(d_in_a == d_in and a.dtype == x.dtype,
            f"smlm_shrink x{tuple(x.shape)} {x.dtype} a{tuple(a.shape)} "
            f"{a.dtype}")
    _check_tiles(T, r, block_t, tile_ids, tile_scale)
    build.check_cuda(x, a, tile_ids, tile_scale)
    s = torch.empty((T, r), dtype=torch.float32, device=x.device)
    fn = build.function("smlm", "smlm_shrink_launch", _SPLIT_ARGS)
    err = fn(x.data_ptr(), a.data_ptr(), tile_ids.data_ptr(),
             tile_scale.data_ptr(), s.data_ptr(), T, n, d_in, r, block_t,
             build.dtype_code(x), build.stream_of(x))
    build.check(err, "smlm")
    smlm_shrink.launches += 1
    return s


smlm_shrink.launches = 0


def smlm_expand(s: torch.Tensor, b: torch.Tensor, tile_ids: torch.Tensor,
                tile_scale: torch.Tensor, *, block_t: int) -> torch.Tensor:
    """SMLM's second launch alone: ``s[t] @ B[id[tile]]`` [T, d_out] in b's
    dtype (zeros on tiles of scale 0), ``s`` the fp32 [T, r] of
    ``smlm_shrink`` summed over the ranks that hold d_in; ``b`` may be a
    rank's slice of d_out.  CPU tensors take the plain version; CUDA
    tensors launch ``smlm_expand_launch`` (``csrc/smlm.cu``)."""
    if s.device.type == "cpu":
        return smlm_expand_ref(s, b, tile_ids, tile_scale, block_t)
    require(s.device.type == "cuda", f"no SMLM kernel for {s.device}")
    T, r = s.shape
    n, r_b, d_out = b.shape
    require(r_b == r and s.dtype == torch.float32,
            f"smlm_expand s{tuple(s.shape)} {s.dtype} b{tuple(b.shape)}")
    _check_tiles(T, r, block_t, tile_ids, tile_scale)
    build.check_cuda(s, b, tile_ids, tile_scale)
    out = torch.empty((T, d_out), dtype=b.dtype, device=s.device)
    fn = build.function("smlm", "smlm_expand_launch", _SPLIT_ARGS)
    err = fn(s.data_ptr(), b.data_ptr(), tile_ids.data_ptr(),
             tile_scale.data_ptr(), out.data_ptr(), T, n, r, d_out, block_t,
             build.dtype_code(b), build.stream_of(s))
    build.check(err, "smlm")
    smlm_expand.launches += 1
    return out


smlm_expand.launches = 0


def smlm_wgrad(x: torch.Tensor, dy: torch.Tensor, s: torch.Tensor,
               gs: torch.Tensor, tile_ids: torch.Tensor,
               tile_scale: torch.Tensor, *, r: int, block_t: int,
               n_slots: int):
    """SMLM's weight gradient (``ref.smlm_wgrad_ref``).  x: [T, d_in]; dy:
    [T, d_out] (x's dtype); s/gs: the forward's and the dX product's kept
    shrinks (``smlm(..., keep_shrink=True)``), covering at least the T
    tokens' tiles; tile_ids/tile_scale: [T / block_t].  Returns ``(dA [n,
    d_in, r], dB [n, r, d_out])`` in x's dtype.  CPU tensors take the plain
    version; CUDA tensors launch ``csrc/smlm_grad.cu``."""
    T, d_in = x.shape
    d_out = dy.shape[1]
    if x.device.type == "cpu":
        return smlm_wgrad_ref(x, dy, unpack_shrink(s, T, r, block_t),
                              unpack_shrink(gs, T, r, block_t), tile_ids,
                              tile_scale, block_t, n_slots)
    require(x.device.type == "cuda", f"no SMLM gradient kernel for "
                                     f"{x.device}")
    require(dy.shape[0] == T and dy.dtype == x.dtype,
            f"smlm_wgrad dy{tuple(dy.shape)} {dy.dtype} against "
            f"x{tuple(x.shape)} {x.dtype}")
    require(block_t > 0 and T % block_t == 0,
            f"T={T} is not a multiple of block_t={block_t}")
    require(0 < r <= MAX_RANK, f"rank {r} outside [1, {MAX_RANK}]")
    nt = T // block_t
    need = nt * -(-block_t // 8) * rank_pad(r) * 8
    for buf in (s, gs):
        require(buf.dtype == torch.float32 and buf.numel() >= need,
                f"shrink buffers must be float32 of at least {need} values")
    require(tile_ids.dtype == torch.int32 and tile_ids.shape == (nt,),
            "tile_ids must be int32 [T / block_t]")
    require(tile_scale.dtype == torch.float32 and tile_scale.shape == (nt,),
            "tile_scale must be float32 [T / block_t]")
    build.check_cuda(x, dy, s, gs, tile_ids, tile_scale)
    da = torch.empty((n_slots, d_in, r), dtype=x.dtype, device=x.device)
    db = torch.empty((n_slots, r, d_out), dtype=x.dtype, device=x.device)
    fn = build.function("smlm_grad", "smlm_wgrad_launch", _WGRAD_ARGS)
    err = fn(x.data_ptr(), dy.data_ptr(), s.data_ptr(), gs.data_ptr(),
             tile_ids.data_ptr(), tile_scale.data_ptr(), da.data_ptr(),
             db.data_ptr(), T, n_slots, d_in, r, d_out, block_t,
             build.dtype_code(x), build.stream_of(x))
    build.check(err, "smlm_grad")
    smlm_wgrad.launches += 1
    return da, db


smlm_wgrad.launches = 0


def smlm_wgrad_split(x: torch.Tensor, dy: torch.Tensor, s: torch.Tensor,
                     gs: torch.Tensor, tile_ids: torch.Tensor,
                     tile_scale: torch.Tensor, *, block_t: int,
                     n_slots: int):
    """``smlm_wgrad`` over the split entries' plain fp32 [T, r] shrinks
    (``smlm_shrink``'s layout: the forward's ``S`` and the dX product's
    ``Gs``, both summed over the ranks that hold d_in), each packed into
    the kernel's layout first (``ref.pack_shrink``: a copy of
    ``T / block_t * ceil(block_t / 8) * 8 * rank_pad(r)`` floats, plain
    PyTorch on every device)."""
    return smlm_wgrad(x, dy, pack_shrink(s, block_t),
                      pack_shrink(gs, block_t), tile_ids, tile_scale,
                      r=s.shape[1], block_t=block_t, n_slots=n_slots)


class SMLMFunction(torch.autograd.Function):
    """SMLM over the ft+pf head with its gradient to x, a and b.  Only the
    first ``n_ft`` tokens (the fine-tune rows, a multiple of ``block_t``)
    carry gradient: the loss reads only them and ft attention sees only ft
    keys, so the prefill rows' output gradient is exactly zero, and their
    dX is returned as zeros without computing it.  The backward runs two
    kernels on the card, SMLM (dX, keeping ``Gs``) and ``smlm_wgrad`` (dA,
    dB), and their plain versions on the CPU; it never falls back."""

    @staticmethod
    def forward(ctx, x, a, b, tile_ids, tile_scale, block_t: int,
                n_ft: int):
        y, s = smlm(x, a, b, tile_ids, tile_scale, block_t=block_t,
                    keep_shrink=True)
        ctx.save_for_backward(x, a, b, tile_ids, tile_scale, s)
        ctx.block_t, ctx.n_ft = block_t, n_ft
        return y

    @staticmethod
    def backward(ctx, dy):
        x, a, b, tile_ids, tile_scale, s = ctx.saved_tensors
        bt, n_ft = ctx.block_t, ctx.n_ft
        nt = n_ft // bt
        ids, scale = tile_ids[:nt], tile_scale[:nt]
        dy_ft = dy[:n_ft].contiguous()
        # dX = (scale dY B^T) A^T: SMLM with the transposed bank slices,
        # written into dX's fine-tune rows; the prefill rows' dX is 0
        dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
        _, gs = smlm(dy_ft, b.transpose(1, 2).contiguous(),
                     a.transpose(1, 2).contiguous(), ids, scale, block_t=bt,
                     keep_shrink=True, out=dx[:n_ft])
        dx[n_ft:].zero_()
        da, db = smlm_wgrad(x[:n_ft], dy_ft, s, gs, ids, scale,
                            r=a.shape[2], block_t=bt, n_slots=a.shape[0])
        return dx, da, db, None, None, None, None
